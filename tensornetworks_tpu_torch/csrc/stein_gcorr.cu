// The recombination of the n+1-column Stein matvec (the gcorr form), FP32,
// for sm_90a.
//
// No TPU kernel stands behind this one: the JAX package computes the same
// function in XLA, as the correction step of stein_matvec_gcorr_tables
// (tensornetworks_tpu/ops/stein.py:406-494), in three TPU layouts (per-bit
// sublane swaps, 0/1-permutation matmuls, a tile-folded hybrid). Here it is
// one launch in place of about five elementwise launches per bit.
//
// With P0 = K q and Q_t = K (S_t o q) the Kronecker-applied columns, S_t the
// score rows, Rv = sum_t S_t and m_t = 1 << (n - 1 - t) (bit t, most
// significant first):
//
//   y[i] = sum_t S_t[i] Q_t[i] + w1 (Rv[i] P0[i] + sum_t Q_t[i]) + w0 P0[i]
//          + sum_t [alpha (S_t[i] P0[i ^ m_t] + Q_t[i ^ m_t]) + gamma P0[i ^ m_t]]
//
// (alpha, gamma, w1, w0: ops/kernels/stein_gcorr.py gcorr_coefficients).
// The TPU layouts need the score tables pre-flipped per bit, because a flip
// there is a relayout; a gather by i ^ m_t costs the card nothing, so those
// tables are not built.
//
// Bound: bytes. S and Q (n rows of 2^n floats each), P0 and Rv read once and
// y written once: (2n + 3) * 4 * 2^n bytes, 2.7 us at n = 16, 51 us at n = 20
// and 0.97 ms at n = 24 at 3.35 TB/s. The arithmetic, about 9 FLOPs per
// element and bit, takes a twentieth of that at the FP32 FMA rate.
//
// Design: one thread per four consecutive indices i0..i0+3, float4 loads and
// one float4 store. For a bit with m_t >= 4 the partners of the four are the
// four consecutive indices at i0 ^ m_t: one more float4 load each from Q_t
// and P0, coalesced (a warp's partners are another contiguous 512 bytes).
// For m_t = 2 and 1 the partners lie in the same float4 and are swapped in
// registers. The partner loads read bytes that other threads read as their
// own: for the low bits the same lines, for the high bits L2 holds them only
// when the partner block runs close in time (at n <= 17 all of Q fits in L2).
// So the traffic lies between the bound and about (3n + 3) * 4 * 2^n bytes.
// Sums accumulate in FP32 per output, in bit order; no atomics, so the result
// does not change from run to run.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

struct F4 {
  float v[4];
};

__device__ __forceinline__ F4 load4(const float* __restrict__ p) {
  const float4 x = __ldg(reinterpret_cast<const float4*>(p));
  return {{x.x, x.y, x.z, x.w}};
}

// One bit's terms for the four outputs, given their partners' values.
__device__ __forceinline__ void accumulate(const F4& s, const F4& qi, const F4& qj, const F4& pj,
                                           float alpha, float gamma, float* sq, float* sumq,
                                           float* flips) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    sq[k] = fmaf(s.v[k], qi.v[k], sq[k]);
    sumq[k] += qi.v[k];
    flips[k] += fmaf(alpha, fmaf(s.v[k], pj.v[k], qj.v[k]), gamma * pj.v[k]);
  }
}

__global__ void __launch_bounds__(kThreads)
    gcorr_combine_kernel(const float* __restrict__ p0, const float* __restrict__ q,
                         const float* __restrict__ st, const float* __restrict__ rv,
                         float* __restrict__ y, float alpha, float gamma, float w1, float w0,
                         int n) {
  const size_t N = size_t(1) << n;
  const size_t i0 = (size_t(blockIdx.x) * kThreads + threadIdx.x) << 2;
  if (i0 >= N) return;
  const F4 p = load4(p0 + i0);
  float sq[4] = {0.f, 0.f, 0.f, 0.f}, sumq[4] = {0.f, 0.f, 0.f, 0.f};
  float flips[4] = {0.f, 0.f, 0.f, 0.f};
  // Bits 0 .. n-3: the partners are another float4.
#pragma unroll 4
  for (int t = 0; t < n - 2; ++t) {
    const size_t row = size_t(t) * N;
    const size_t j0 = i0 ^ (N >> (t + 1));
    accumulate(load4(st + row + i0), load4(q + row + i0), load4(q + row + j0), load4(p0 + j0),
               alpha, gamma, sq, sumq, flips);
  }
  // Bits n-2 (m = 2) and n-1 (m = 1): the partners are in the same float4.
  {
    const size_t row = size_t(n - 2) * N;
    const F4 qi = load4(q + row + i0);
    accumulate(load4(st + row + i0), qi, F4{{qi.v[2], qi.v[3], qi.v[0], qi.v[1]}},
               F4{{p.v[2], p.v[3], p.v[0], p.v[1]}}, alpha, gamma, sq, sumq, flips);
  }
  {
    const size_t row = size_t(n - 1) * N;
    const F4 qi = load4(q + row + i0);
    accumulate(load4(st + row + i0), qi, F4{{qi.v[1], qi.v[0], qi.v[3], qi.v[2]}},
               F4{{p.v[1], p.v[0], p.v[3], p.v[2]}}, alpha, gamma, sq, sumq, flips);
  }
  const F4 r = load4(rv + i0);
  float out[4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    out[k] = sq[k] + fmaf(w1, fmaf(r.v[k], p.v[k], sumq[k]), fmaf(w0, p.v[k], flips[k]));
  *reinterpret_cast<float4*>(y + i0) = make_float4(out[0], out[1], out[2], out[3]);
}

}  // namespace

extern "C" {

// p0, rv, y: (2^n,); q, st: (n, 2^n); all float32, contiguous, 16-byte
// aligned; 2 <= n <= 30. One launch on the given stream.
int tn_stein_gcorr_combine(const float* p0, const float* q, const float* st, const float* rv,
                           float* y, float alpha, float gamma, float w1, float w0, int n,
                           void* stream) {
  if (n < 2 || n > 30) return (int)cudaErrorInvalidValue;
  const size_t quads = size_t(1) << (n - 2);
  const unsigned blocks = (unsigned)((quads + kThreads - 1) / kThreads);
  gcorr_combine_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      p0, q, st, rv, y, alpha, gamma, w1, w0, n);
  return cudaGetLastError();
}

}  // extern "C"
