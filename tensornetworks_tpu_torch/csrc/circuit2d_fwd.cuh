// The n <= 17 circuit forward (tn_circuit2d_forward) as one persistent
// cooperative kernel, FP32 on planar (re, im) planes, for sm_90a.
//
// Replaces the TPU kernel tensornetworks_tpu/ops/pallas/circuit2d.py
// make_pallas_circuit2d_probs -> kernel / fwd_kernel (circuit2d.py:164,
// :185; their pallas_calls at :295, :306): the whole circuit from
// |0...0> (or the Hadamard wall) to |psi|^2. A layer is X <- Mr X Mc^T, then
// the layer's CNOTs as one exact GF(2)-linear index map with its CZ sign
// (layer_map.cuh PermSpec), each layer's own: the chain ansaetze repeat one
// map, bn_structured alternates two. phi0 depends on the wall alone, never
// on a map.
//
// Bound at n=16, L=4 (R=C=256): 8 complex products of 256^3, 8 L (R^2 C +
// R C^2) = 1.07 GFLOP of FP32 FMA, 16 us at 67 TFLOP/s; about 2 us a
// product. Run as an init and two GEMM launches per layer (9 launches at
// L=4, the host launcher in circuit_layers.cuh that the grid forward
// keeps), a launch and its drain cost more than the product in it. Here one launch walks the
// whole forward (circuit_units.cuh: one block of 256 threads on every SM,
// grid-wide barriers between the phases); the state, tmp and the operators
// (1.5 MB at n=16) stay in L2.
//
// Buffers: X (the xr, xi outputs) and tmp (2, R, C). Phases:
//   phi0:    tmp = Mr[0] X0 in closed form: with the wall X0 = 2^(-n/2) 1,
//            so tmp[i, j] = 2^(-n/2) sum_k Mr[0][i, k] (a warp per row, its
//            lanes' partial sums combined by shuffles in a fixed order);
//            without it X0 = e00, so tmp[i, j] = Mr[0][i, 0] [j = 0];
//   phiR(l): X = scatter(tmp Mc[l]^T): the K-split sum's store sends element
//            (m, n) to d = dst(m C + n) (the map evaluated once per
//            element) times the CZ sign at d, and on the last layer also
//            writes probs[d] = |z|^2;
//   phiL(l): tmp = Mr[l] X, for l >= 1.
// In the order phi0, phiR(0), phiL(1), phiR(1), ..., phiR(L-1): 2L phases
// and 2L - 1 barriers (8 and 7 at L=4), in place of 2L + 1 launches. No
// phase reads a buffer it writes, and the scatter is a bijection, so each X
// element is written once per layer.
//
// Units: a 256^2 product has only 64 tiles of 32x32, so the forward's units
// are 32x16 output tiles (4x2 complex register tiles, the four-way K-split
// kept): 128 units a phase at n=16 (256 at n=17, 64 at n=15), each 32 x 16
// outputs x 256 complex MACs, about 2 us at one SM's share of the FMA peak.
//
// Precision P (mma_bf16.cuh): the products run the units' FP32 FMA loops
// (kHighest) or their bf16 tensor-core passes (kHigh, kDefault). phi0 is
// the product Mr[0] X0 at the same precision: both operands rounded
// (kDefault) or split (kHigh), the wall's amplitude a as any entry of X0
// (exact in bf16 for even n, not for odd n). With the wall it is
//   kDefault: bf16(a) sum_k bf16(m_k);
//   kHigh:    a_hi sum_k (m_hi + m_lo) + a_lo sum_k m_hi,
// the three passes' terms regrouped; without it X0 = e00 and 1 is exact.
//
// Flat state indices are 32-bit, as in circuit_layers.cuh.

#pragma once

#include "circuit_units.cuh"

namespace tn {
namespace fwd {

using namespace unit;

constexpr int TN = 16;  // output columns of a unit

struct Args {
  const float* mr_re; const float* mr_im; const float* mc_re; const float* mc_im;
  float* probs; float* xr; float* xi;
  float* tmp;              // (2, R, C)
  const unsigned* masks;   // (2 layers, n): layer l's row masks, then its CZ masks
  int n, layers, has_wall;
  float amp;               // 2^(-n/2), the wall's amplitude
};

template <int P>
__global__ void __launch_bounds__(THREADS, 1) circuit2d_fwd_kernel(Args a) {
  extern __shared__ __align__(16) float smem[];
  __shared__ PermSpec spec;
  namespace cg = cooperative_groups;
  cg::grid_group grid = cg::this_grid();

  const int n = a.n, rb = (n + 1) / 2, cb = n - rb;
  const int R = 1 << rb, C = 1 << cb, S = R * C;
  float* const tr = a.tmp;
  float* const ti = a.tmp + S;

  // phi0: tmp = Mr[0] X0, a warp per row
  const int lane = threadIdx.x % 32, warps = gridDim.x * (THREADS / 32);
  for (int i = blockIdx.x * (THREADS / 32) + threadIdx.x / 32; i < R; i += warps) {
    const float* mr = a.mr_re + (long long)i * R;
    const float* mi = a.mr_im + (long long)i * R;
    float sr, si;
    if (a.has_wall) {
      sr = 0.f;
      si = 0.f;
      float hr = 0.f, hi = 0.f;  // kHigh: the sums of the hi parts alone
      for (int k = lane; k < R; k += 32) {
        if constexpr (P == kHighest) {
          sr += mr[k];
          si += mi[k];
        } else {
          sr += mma::operand<P>(mr[k]);
          si += mma::operand<P>(mi[k]);
          if constexpr (P == kHigh) {
            hr += mma::operand<kDefault>(mr[k]);
            hi += mma::operand<kDefault>(mi[k]);
          }
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        sr += __shfl_xor_sync(0xffffffffu, sr, off);
        si += __shfl_xor_sync(0xffffffffu, si, off);
        if constexpr (P == kHigh) {
          hr += __shfl_xor_sync(0xffffffffu, hr, off);
          hi += __shfl_xor_sync(0xffffffffu, hi, off);
        }
      }
      if constexpr (P == kHighest) {
        sr *= a.amp;
        si *= a.amp;
      } else {
        const float a_hi = mma::operand<kDefault>(a.amp);
        if constexpr (P == kHigh) {
          const float a_lo = mma::operand<kDefault>(a.amp - a_hi);
          sr = a_hi * sr + a_lo * hr;
          si = a_hi * si + a_lo * hi;
        } else {
          sr *= a_hi;
          si *= a_hi;
        }
      }
    } else if constexpr (P == kHighest) {
      sr = mr[0];
      si = mi[0];
    } else {
      sr = mma::operand<P>(mr[0]);
      si = mma::operand<P>(mi[0]);
    }
    for (int j = lane; j < C; j += 32) {
      const bool on = a.has_wall || j == 0;
      tr[(long long)i * C + j] = on ? sr : 0.f;
      ti[(long long)i * C + j] = on ? si : 0.f;
    }
  }
  grid.sync();

  for (int l = 0;; ++l) {
    // phiR(l): X = scatter(tmp Mc[l]^T), |z|^2 on the last layer
    load_spec(spec, a.masks, n, l);
    Prod right = {};
    right.a_re = tr; right.a_im = ti; right.a_sm = C; right.a_sk = 1;
    right.b_re = a.mc_re + (long long)l * C * C; right.b_im = a.mc_im + (long long)l * C * C;
    right.b_sk = 1; right.b_sn = C;
    right.c_re = a.xr; right.c_im = a.xi;
    right.M = R; right.N = C; right.K = C; right.batch = 1;
    set_vec(right);
    const bool last = l == a.layers - 1;
    run<false, false, TN, true, P>(right, nullptr, smem, &spec, last ? a.probs : nullptr);
    if (last) break;
    grid.sync();

    // phiL(l + 1): tmp = Mr[l + 1] X
    Prod left = {};
    left.a_re = a.mr_re + (long long)(l + 1) * R * R;
    left.a_im = a.mr_im + (long long)(l + 1) * R * R;
    left.a_sm = R; left.a_sk = 1;
    left.b_re = a.xr; left.b_im = a.xi; left.b_sk = C; left.b_sn = 1;
    left.c_re = tr; left.c_im = ti; left.c_sm = C;
    left.M = R; left.N = C; left.K = R; left.batch = 1;
    set_vec(left);
    run<false, false, TN, false, P>(left, nullptr, smem);
    grid.sync();
  }
}

// One cooperative launch of one block per SM, or the error that refused it
// (nothing launched).
template <int P>
inline cudaError_t circuit_forward_persistent(const Args& a, cudaStream_t st) {
  static PerDevice<LaunchPlan> plans;
  return launch_persistent(circuit2d_fwd_kernel<P>, plans, a, st);
}

}  // namespace fwd
}  // namespace tn
