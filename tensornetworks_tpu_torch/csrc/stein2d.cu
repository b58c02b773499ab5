// Two-sided Kronecker apply of the Hamming base kernel to the 3n+1 Stein
// columns, FP32, for sm_90a.
//
// Replaces the TPU kernel of tensornetworks_tpu/ops/pallas/stein2d.py:
//   make_pallas_stein2d_matvec -> kernel   (tn_stein2d_apply)
//
// For every column block i, Y_i = Ar V_i Ac^T with Ar = A^{(x)rb},
// Ac = A^{(x)cb}, A = [[1, a], [a, 1]], each V_i an (R, C) matrix. The V build
// and the closed-form recombination stay outside, in plain torch, as they do
// around the TPU kernel.
//
// Design: two launches of the batched real FP32 GEMM of tn_gemm.cuh, one per
// side, over all 3n+1 blocks at once (T = Ar V_i, then Y_i = T_i Ac^T through
// a transposed stride). The Kronecker structure would also allow the apply as
// n butterfly passes of O(2^n) each; the dense form is kept here because it
// is the TPU kernel's function and keeps to one well-understood device code
// shared with the circuit kernels.
//
// Bound at n=16 (R=C=256, 49 blocks, V = 12.8 MB):
//   2 * 49 * (R^2 C + R C^2) = 3.29 GFLOP FP32 -> 49 us at 67 TFLOP/s,
//   V + Y + Ar + Ac = 25.9 MB -> 7.7 us at 3.35 TB/s: bound by FP32 FMA.
// 49 x 16 tiles of 64x64 give 784 blocks, several per SM; the intermediate T
// (12.8 MB) stays in the 50 MB L2 between the two launches.

#include "tn_gemm.cuh"

extern "C" {

// ar: (R, R); ac: (C, C); v, y, tmp: (cols, R, C).
int tn_stein2d_apply(const float* ar, const float* ac, const float* v, float* y, float* tmp,
                     int R, int C, int cols, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const tn::PermSpec none = {};
  const long long S = (long long)R * C;
  tn::GemmArgs left = tn::gemm_args();
  left.a_re = ar; left.a_sm = R; left.a_sk = 1;
  left.b_re = v; left.b_sb = S; left.b_sk = C; left.b_sn = 1;
  left.c_re = tmp; left.c_sb = S; left.c_sm = C; left.c_sn = 1;
  left.M = R; left.N = C; left.K = R; left.batch = cols;
  cudaError_t err = tn::launch_gemm<false>(left, none, st);
  if (err != cudaSuccess) return err;
  tn::GemmArgs right = tn::gemm_args();
  right.a_re = tmp; right.a_sb = S; right.a_sm = C; right.a_sk = 1;
  right.b_re = ac; right.b_sk = 1; right.b_sn = C;
  right.c_re = y; right.c_sb = S; right.c_sm = C; right.c_sn = 1;
  right.M = R; right.N = C; right.K = C; right.batch = cols;
  return tn::launch_gemm<false>(right, none, st);
}

}  // extern "C"
