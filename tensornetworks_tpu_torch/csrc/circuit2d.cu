// Whole-circuit forward and adjoint backward of the 2D super-block
// statevector, FP32 on planar (re, im) planes, for sm_90a.
//
// Replaces the TPU kernels of tensornetworks_tpu/ops/pallas/circuit2d.py:
//   make_pallas_circuit2d_probs -> kernel / fwd_kernel   (tn_circuit2d_forward)
//   make_pallas_circuit2d_probs -> bwd_kernel            (tn_circuit2d_backward)
//
// The state is the (R, C) = (2^ceil(n/2), 2^floor(n/2)) matrix X (row qubits
// 0..rb-1, column qubits rb..n-1). A layer is, in the TPU kernel's order:
// rotations X <- Mr X Mc^T, row-chain CNOT permutation, boundary CNOT,
// column-chain permutation, ring CNOT, CZ signs. At n=16 one plane pair is
// 512 KB, more than a block's 227 KB of shared memory, so the TPU design of a
// VMEM-resident state does not carry over: each C entry point below is a host
// driver that issues a short sequence of launches on the caller's stream.
//
// Design: the two rotations are tiled FP32 complex GEMMs (tn_gemm.cuh). All
// CNOTs of a layer are one GF(2)-linear map of the flat index, so the four
// permutation steps (row chain, boundary, column chain, ring) compose into
// one exact index map, and the CZ gates into one sign evaluated at the
// destination. The TPU kernel ran the boundary and ring CNOTs as H.mask.H
// matmuls; the index map computes the same function exactly and with no
// arithmetic. The forward applies it in the epilogue of the right GEMM
// (a scatter), and writes |psi|^2 there on the last layer. The backward
// undoes it with a gather kernel, then pulls the state and the cotangent
// back through the conjugate rotations as one batched GEMM of two, and
// forms the per-layer operator gradients as complex GEMMs.
//
// Bound at n=16, L=4 (R=C=256), as the dense products it performs:
//   forward : 8 L (R^2 C + R C^2) = 1.07 GFLOP FP32, ~4.8 MB moved
//   backward: 24 L (R^2 C + R C^2) = 3.22 GFLOP FP32, ~8.9 MB moved
// Both are bound by FP32 FMA throughput (67 TFLOP/s on the H100 SXM: 16 us
// and 48 us). The GEMM keeps operands in shared memory and accumulators in
// registers; at these sizes a single product has only 64 blocks of 32x32, so
// the first version is bound by occupancy and launch latency, not by the FMA
// units (see PERF.md).

#include <cmath>

#include "tn_gemm.cuh"

namespace {

using tn::GemmArgs;
using tn::PermSpec;

PermSpec make_spec(int n, const unsigned* rows, const unsigned* cz) {
  PermSpec s = {};
  s.nbits = n;
  for (int k = 0; k < n; ++k) {
    s.rows[k] = rows[k];
    s.cz[k] = cz ? cz[k] : 0u;
  }
  return s;
}

__global__ void init_state_kernel(float* re, float* im, int size, float amp, int wall) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= size) return;
  re[i] = wall ? amp : (i == 0 ? 1.f : 0.f);
  im[i] = 0.f;
}

// buf planes: [x_re, x_im, l_re, l_im]; lambda = 2 g psi.
__global__ void cotangent_init_kernel(const float* xr, const float* xi, const float* g,
                                      float* buf, int size) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= size) return;
  const float a = xr[i], b = xi[i], two_g = 2.f * g[i];
  buf[i] = a;
  buf[size + i] = b;
  buf[2 * size + i] = two_g * a;
  buf[3 * size + i] = two_g * b;
}

// Inverse of the forward's scatter on all four planes: Z[i] = s(d) Y[d], d = dst(i).
__global__ void unpermute_kernel(const float* src, float* dst, int size, PermSpec spec) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= size) return;
  const unsigned d = tn::perm_dst(spec, (unsigned)i);
  const float s = tn::perm_sign(spec, d);
#pragma unroll
  for (int p = 0; p < 4; ++p) dst[p * size + i] = s * src[p * size + d];
}

inline int blocks_for(int size) { return (size + 255) / 256; }

}  // namespace

extern "C" {

// probs, xr, xi: (R, C) outputs; tmp: (2, R, C) scratch.
// rows: n masks of the chain map; cz: (layers, n) CZ masks.
int tn_circuit2d_forward(const float* mr_re, const float* mr_im, const float* mc_re,
                         const float* mc_im, float* probs, float* xr, float* xi, float* tmp,
                         int n, int layers, int has_wall, const unsigned* rows,
                         const unsigned* cz, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rb = (n + 1) / 2, cb = n - rb;
  const int R = 1 << rb, C = 1 << cb, S = R * C;
  const float amp = (float)std::pow(2.0, -0.5 * n);
  init_state_kernel<<<blocks_for(S), 256, 0, st>>>(xr, xi, S, amp, has_wall);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const PermSpec none = {};
  for (int l = 0; l < layers; ++l) {
    // tmp = Mr[l] X
    GemmArgs left = tn::gemm_args();
    left.a_re = mr_re + (long long)l * R * R; left.a_im = mr_im + (long long)l * R * R;
    left.a_sm = R; left.a_sk = 1;
    left.b_re = xr; left.b_im = xi; left.b_sk = C; left.b_sn = 1;
    left.c_re = tmp; left.c_im = tmp + S; left.c_sm = C; left.c_sn = 1;
    left.M = R; left.N = C; left.K = R;
    err = tn::launch_gemm<true>(left, none, st);
    if (err != cudaSuccess) return err;
    // X = perm/sign(tmp Mc[l]^T)
    GemmArgs right = tn::gemm_args();
    right.a_re = tmp; right.a_im = tmp + S; right.a_sm = C; right.a_sk = 1;
    right.b_re = mc_re + (long long)l * C * C; right.b_im = mc_im + (long long)l * C * C;
    right.b_sk = 1; right.b_sn = C;
    right.c_re = xr; right.c_im = xi;
    right.M = R; right.N = C; right.K = C;
    right.scatter = 1;
    right.probs = (l == layers - 1) ? probs : nullptr;
    err = tn::launch_gemm<true>(right, make_spec(n, rows, cz + (long long)l * n), st);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// xr, xi, g: (R, C) inputs; dmr_*: (layers, R, R) and dmc_*: (layers, C, C)
// outputs; buf_a, buf_b: (4, R, C) scratch each.
int tn_circuit2d_backward(const float* mr_re, const float* mr_im, const float* mc_re,
                          const float* mc_im, const float* xr, const float* xi,
                          const float* g, float* dmr_re, float* dmr_im, float* dmc_re,
                          float* dmc_im, float* buf_a, float* buf_b, int n, int layers,
                          const unsigned* rows, const unsigned* cz, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rb = (n + 1) / 2, cb = n - rb;
  const int R = 1 << rb, C = 1 << cb, S = R * C;
  const PermSpec none = {};
  cotangent_init_kernel<<<blocks_for(S), 256, 0, st>>>(xr, xi, g, buf_a, S);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  float* A = buf_a;  // state after the current layer: [x_re, x_im, l_re, l_im]
  float* B = buf_b;
  for (int l = layers - 1; l >= 0; --l) {
    const float* mr_r = mr_re + (long long)l * R * R;
    const float* mr_i = mr_im + (long long)l * R * R;
    const float* mc_r = mc_re + (long long)l * C * C;
    const float* mc_i = mc_im + (long long)l * C * C;
    // Undo the permutation and signs: B = after the rotations.
    unpermute_kernel<<<blocks_for(S), 256, 0, st>>>(A, B, S, make_spec(n, rows, cz + (long long)l * n));
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    // A = B conj(Mc): state and cotangent before the right rotation.
    GemmArgs col = tn::gemm_args();
    col.a_re = B; col.a_im = B + S; col.a_sb = 2LL * S; col.a_sm = C; col.a_sk = 1;
    col.b_re = mc_r; col.b_im = mc_i; col.b_sk = C; col.b_sn = 1; col.b_conj = -1.f;
    col.c_re = A; col.c_im = A + S; col.c_sb = 2LL * S; col.c_sm = C; col.c_sn = 1;
    col.M = R; col.N = C; col.K = C; col.batch = 2;
    if ((err = tn::launch_gemm<true>(col, none, st)) != cudaSuccess) return err;
    // dMc[l] = lambda_after^T conj(x_before)
    GemmArgs dmc = tn::gemm_args();
    dmc.a_re = B + 2LL * S; dmc.a_im = B + 3LL * S; dmc.a_sm = 1; dmc.a_sk = C;
    dmc.b_re = A; dmc.b_im = A + S; dmc.b_sk = C; dmc.b_sn = 1; dmc.b_conj = -1.f;
    dmc.c_re = dmc_re + (long long)l * C * C; dmc.c_im = dmc_im + (long long)l * C * C;
    dmc.c_sm = C; dmc.c_sn = 1;
    dmc.M = C; dmc.N = C; dmc.K = R;
    if ((err = tn::launch_gemm<true>(dmc, none, st)) != cudaSuccess) return err;
    // B = Mr^dagger A: state and cotangent before the layer.
    GemmArgs row = tn::gemm_args();
    row.a_re = mr_r; row.a_im = mr_i; row.a_sm = 1; row.a_sk = R; row.a_conj = -1.f;
    row.b_re = A; row.b_im = A + S; row.b_sb = 2LL * S; row.b_sk = C; row.b_sn = 1;
    row.c_re = B; row.c_im = B + S; row.c_sb = 2LL * S; row.c_sm = C; row.c_sn = 1;
    row.M = R; row.N = C; row.K = R; row.batch = 2;
    if ((err = tn::launch_gemm<true>(row, none, st)) != cudaSuccess) return err;
    // dMr[l] = lambda_after x_before^H
    GemmArgs dmr = tn::gemm_args();
    dmr.a_re = A + 2LL * S; dmr.a_im = A + 3LL * S; dmr.a_sm = C; dmr.a_sk = 1;
    dmr.b_re = B; dmr.b_im = B + S; dmr.b_sk = 1; dmr.b_sn = C; dmr.b_conj = -1.f;
    dmr.c_re = dmr_re + (long long)l * R * R; dmr.c_im = dmr_im + (long long)l * R * R;
    dmr.c_sm = R; dmr.c_sn = 1;
    dmr.M = R; dmr.N = R; dmr.K = C;
    if ((err = tn::launch_gemm<true>(dmr, none, st)) != cudaSuccess) return err;
    float* t = A; A = B; B = t;
  }
  return cudaSuccess;
}

}  // extern "C"
