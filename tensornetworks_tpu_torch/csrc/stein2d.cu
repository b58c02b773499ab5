// Two-sided Kronecker apply of the Hamming base kernel to the 3n+1 Stein
// columns, FP32, for sm_90a.
//
// Replaces the TPU kernels of tensornetworks_tpu/ops/pallas/stein2d.py:
//   make_pallas_stein2d_matvec      -> kernel   (tn_stein2d_apply)
//   make_pallas_stein2d_matvec_grid -> kernel   (tn_stein2d_apply_grid)
//
// For every column block i, Y_i = Ar V_i Ac^T with Ar = A^{(x)rb},
// Ac = A^{(x)cb}, A = [[1, a], [a, 1]], each V_i an (R, C) matrix. The V build
// and the closed-form recombination stay outside, in plain torch, as they do
// around the TPU kernels.
//
// Design: two launches of the batched real FP32 GEMM of tn_gemm.cuh per batch
// of blocks, one per side (T = Ar V_i, then Y_i = T_i Ac^T through a
// transposed stride). The Kronecker structure would also allow the apply as
// n butterfly passes of O(2^n) each; the dense form is kept here because it
// is the TPU kernels' function and keeps to one well-understood device code
// shared with the circuit kernels.
//
// tn_stein2d_apply (n <= 17) takes all blocks in one batch. Bound at n=16
// (R=C=256, 49 blocks, V = 12.8 MB):
//   2 * 49 * (R^2 C + R C^2) = 3.29 GFLOP FP32 -> 49 us at 67 TFLOP/s,
//   V + Y + Ar + Ac = 25.9 MB -> 7.7 us at 3.35 TB/s: bound by FP32 FMA.
// 49 x 16 tiles of 64x64 give 784 blocks, several per SM; the intermediate T
// (12.8 MB) stays in the 50 MB L2 between the two launches.
//
// tn_stein2d_apply_grid (n >= 18) is the large-n tiling. The TPU ran one grid
// step per block to bound VMEM. Here one batch of all 61 blocks at n=20 would
// need a 256 MB intermediate T that round-trips HBM, so the blocks go in
// chunks of `chunk` (chosen by the caller so that a chunk's T, 4 MB a block
// at n=20, stays in L2), two launches per chunk, scratch O(chunk). Bound at
// n=20 (R=C=1024, 61 blocks, V = 256 MB):
//   2 * 61 * (R^2 C + R C^2) = 2.6e11 FLOP FP32 -> 3.91 ms at 67 TFLOP/s,
//   V + Y + Ar + Ac = 520 MB -> 0.16 ms at 3.35 TB/s: bound by FP32 FMA.

#include "tn_gemm.cuh"

namespace {

// Y_i = Ar V_i Ac^T for `cols` consecutive blocks; tmp holds `cols` blocks.
cudaError_t apply_blocks(const float* ar, const float* ac, const float* v, float* y, float* tmp,
                         int R, int C, int cols, cudaStream_t st) {
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

}  // namespace

extern "C" {

// ar: (R, R); ac: (C, C); v, y, tmp: (cols, R, C).
int tn_stein2d_apply(const float* ar, const float* ac, const float* v, float* y, float* tmp,
                     int R, int C, int cols, void* stream) {
  return apply_blocks(ar, ac, v, y, tmp, R, C, cols, static_cast<cudaStream_t>(stream));
}

// ar: (R, R); ac: (C, C); v, y: (cols, R, C); tmp: (chunk, R, C).
int tn_stein2d_apply_grid(const float* ar, const float* ac, const float* v, float* y,
                          float* tmp, int R, int C, int cols, int chunk, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long S = (long long)R * C;
  for (int c0 = 0; c0 < cols; c0 += chunk) {
    const int nb = cols - c0 < chunk ? cols - c0 : chunk;
    const cudaError_t err = apply_blocks(ar, ac, v + c0 * S, y + c0 * S, tmp, R, C, nb, st);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // extern "C"
