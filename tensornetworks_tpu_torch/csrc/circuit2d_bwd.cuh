// The n <= 17 circuit backward (tn_circuit2d_backward) as one persistent
// cooperative kernel, FP32 on planar (re, im) planes, for sm_90a.
//
// Replaces the TPU kernel tensornetworks_tpu/ops/pallas/circuit2d.py
// make_pallas_circuit2d_probs -> bwd_kernel: the adjoint sweep in reverse
// layer order, pulling the state and the cotangent lambda = 2 g psi back
// through each layer and emitting dMr[l] = lambda x^H and dMc[l] =
// lambda^T conj(x).
//
// Bound at n=16, L=4 (R=C=256): 16 complex products of 256^3, 24 L (R^2 C +
// R C^2) = 3.22 GFLOP of FP32 FMA, 48 us at 67 TFLOP/s; about 3 us a product.
// The earlier design (circuit_layers.cuh circuit_backward, still the n >= 18
// backward) issued 21 dependent launches of 64-128 blocks each: a launch and
// its drain cost more than the product in it. Here one launch walks the
// whole sweep (circuit_units.cuh: one block of 256 threads on every SM,
// grid-wide barriers between the phases), and every buffer the sweep
// touches -- four (4, R, C) buffers of 1 MB, 2 MB of operators, 2 MB of
// gradients at n=16 -- stays in the 50 MB L2.
//
// Buffers (scratch, 4 x (4, R, C), planes [x_re, x_im, l_re, l_im]): U[0],
// U[1] the state and cotangent after layer l's rotations (by layer parity),
// V after its column pull-back, W before the layer. Phases, for l = L-1 .. 0:
//   phi1: U[l%2] = unpermute(W) (elementwise: the inverse of the forward's
//         index map and sign; at l = L-1 read from x and 2 g x instead), and,
//         for l < L-1, dMr[l+1] = l_V x_W^H and dMc[l+1] = l_U[(l+1)%2]^T
//         conj(x_V) from the previous layer's buffers;
//   phi2: V = U[l%2] conj(Mc[l])        (state and cotangent, batch 2);
//   phi3: W = Mr[l]^H V                 (batch 2);
// then a final phase dMr[0], dMc[0]. No phase reads a buffer it writes; U
// alternates so that phi1 can form dMc[l+1] while it writes U[l%2]. That is
// 3L + 1 phases and 3L barriers (13 and 12 at L=4), in place of 21 launches.
//
// Work units (circuit_units.cuh): one 32x32 output tile of one product,
// four groups of 64 threads over four K-ranges, summed in shared memory in
// a fixed order. At n=16 every phase has 128 units of 256^2 x 64 complex
// MACs (phi1: 64 + 64, phi2 and phi3: 2 x 64, the last phase 64 + 64): one
// unit on each of 128 SMs.
//
// Precision: this kernel runs `highest` (FP32). The bf16 variants (`high`,
// `default`) are the kernel of circuit_bf16.cuh.
//
// Flat state indices are 32-bit, as in circuit_layers.cuh.

#pragma once

#include "circuit_units.cuh"

namespace tn {
namespace bwd {

using namespace unit;

struct Args {
  const float* mr_re; const float* mr_im; const float* mc_re; const float* mc_im;
  const float* xr; const float* xi; const float* g;
  float* dmr_re; float* dmr_im; float* dmc_re; float* dmc_im;
  float* scratch;          // 4 x (4, R, C): U[0], U[1], V, W
  const unsigned* masks;   // (2 layers, n): layer l's row masks, then its CZ masks
  int n, layers;
};

__global__ void __launch_bounds__(THREADS, 1) circuit2d_bwd_kernel(Args a) {
  extern __shared__ __align__(16) float smem[];
  __shared__ PermSpec spec;
  namespace cg = cooperative_groups;
  cg::grid_group grid = cg::this_grid();

  const int n = a.n, rb = (n + 1) / 2, cb = n - rb;
  const int R = 1 << rb, C = 1 << cb, S = R * C;
  float* const U[2] = {a.scratch, a.scratch + 4LL * S};
  float* const V = a.scratch + 8LL * S;
  float* const W = a.scratch + 12LL * S;

  // dMr[l] = l_V x_W^H and dMc[l] = l_U^T conj(x_V), U = U[l % 2].
  auto grads = [&](int l) {
    const float* u = U[l % 2];
    Prod dmr = {};
    dmr.a_re = V + 2LL * S; dmr.a_im = V + 3LL * S; dmr.a_sm = C; dmr.a_sk = 1;
    dmr.b_re = W; dmr.b_im = W + S; dmr.b_sk = 1; dmr.b_sn = C;
    dmr.c_re = a.dmr_re + (long long)l * R * R; dmr.c_im = a.dmr_im + (long long)l * R * R;
    dmr.c_sm = R; dmr.M = R; dmr.N = R; dmr.K = C; dmr.batch = 1;
    set_vec(dmr);
    Prod dmc = {};
    dmc.a_re = u + 2LL * S; dmc.a_im = u + 3LL * S; dmc.a_sm = 1; dmc.a_sk = C;
    dmc.b_re = V; dmc.b_im = V + S; dmc.b_sk = C; dmc.b_sn = 1;
    dmc.c_re = a.dmc_re + (long long)l * C * C; dmc.c_im = a.dmc_im + (long long)l * C * C;
    dmc.c_sm = C; dmc.M = C; dmc.N = C; dmc.K = R; dmc.batch = 1;
    set_vec(dmc);
    run<false, true>(dmr, &dmc, smem);
  };

  for (int l = a.layers - 1; l >= 0; --l) {
    // phi1: undo layer l's index map and signs into U[l % 2]
    load_spec(spec, a.masks, n, l);
    float* const u = U[l % 2];
    for (int i = blockIdx.x * THREADS + threadIdx.x; i < S; i += gridDim.x * THREADS) {
      const unsigned d = perm_dst(spec, (unsigned)i);
      const float s = perm_sign(spec, d);
      float v[4];
      if (l == a.layers - 1) {  // the forward's output: x and lambda = 2 g x
        const float xr = a.xr[d], xi = a.xi[d], two_g = 2.f * a.g[d];
        v[0] = xr; v[1] = xi; v[2] = two_g * xr; v[3] = two_g * xi;
      } else {
#pragma unroll
        for (int pl = 0; pl < 4; ++pl) v[pl] = W[(long long)pl * S + d];
      }
#pragma unroll
      for (int pl = 0; pl < 4; ++pl) u[(long long)pl * S + i] = s * v[pl];
    }
    if (l < a.layers - 1) grads(l + 1);
    grid.sync();

    // phi2: V = U conj(Mc[l]), state and cotangent
    Prod col = {};
    col.a_re = u; col.a_im = u + S; col.a_sb = 2LL * S; col.a_sm = C; col.a_sk = 1;
    col.b_re = a.mc_re + (long long)l * C * C; col.b_im = a.mc_im + (long long)l * C * C;
    col.b_sk = C; col.b_sn = 1;
    col.c_re = V; col.c_im = V + S; col.c_sb = 2LL * S; col.c_sm = C;
    col.M = R; col.N = C; col.K = C; col.batch = 2;
    set_vec(col);
    run<false, true>(col, nullptr, smem);
    grid.sync();

    // phi3: W = Mr[l]^H V, state and cotangent
    Prod row = {};
    row.a_re = a.mr_re + (long long)l * R * R; row.a_im = a.mr_im + (long long)l * R * R;
    row.a_sm = 1; row.a_sk = R;
    row.b_re = V; row.b_im = V + S; row.b_sb = 2LL * S; row.b_sk = C; row.b_sn = 1;
    row.c_re = W; row.c_im = W + S; row.c_sb = 2LL * S; row.c_sm = C;
    row.M = R; row.N = C; row.K = R; row.batch = 2;
    set_vec(row);
    run<true, false>(row, nullptr, smem);
    grid.sync();
  }
  grads(0);
}

// One cooperative launch of one block per SM, or the error that refused it
// (nothing launched).
inline cudaError_t circuit_backward_persistent(const Args& a, cudaStream_t st) {
  static PerDevice<LaunchPlan> plans;
  return launch_persistent(circuit2d_bwd_kernel, plans, a, st);
}

}  // namespace bwd
}  // namespace tn
