// The bf16 tensor-core products of the circuit kernels' `default` and `high`
// precisions (ops/kernels/precision.py), shared by tn_gemm.cuh's gemm_kernel
// (kernels 5-6 at n = 18-19) and the work units of circuit_units.cuh
// (kernel 1); circuit_bf16.cuh (kernel 2) builds on the split and the real
// products.
//
// Replaces the dot precision of the TPU kernels' `_dot` (circuit2d.py,
// circuit2d_grid.py), which Mosaic lowers as one bf16 pass (DEFAULT) or six
// (HIGHEST); HIGH is three. Here:
//   kHighest: the kernels' FP32 FMA loops, untouched by this header;
//   kHigh:    three bf16 passes per real product, lo*hi + hi*lo + hi*hi
//             (hi = bf16_rn(x), lo = bf16_rn(x - hi)), FP32 accumulation;
//   kDefault: one bf16 pass, hi*hi, FP32 accumulation.
// A product of two bf16 values is exact in FP32, so a plain version that
// rounds (or splits) both operand planes and sums in FP32 emulates a pass up
// to the order of the FP32 sums.
//
// Design: the operand tiles stay the loops' FP32 k-major tiles in shared
// memory (the cp.async rings are unchanged). A warp reads its fragments of
// the mma.sync.m16n8k16 layout from them as scalars, rounds them with
// cvt.rn.bf16x2.f32 (and forms lo for kHigh), and issues four real products
// per complex one. Conjugation stays a sign: the imaginary plane's bf16
// fragment is negated (exact). The FP32 reads walk k with a stride of the
// tile's row length; gemm_kernel's padded rows (BM + 1, BN + 1) and the
// units' 36-float rows spread the lanes over the banks. Kernels 5-6 run their
// products of at least 128 tiles on the TMA + wgmma loop of wgmma_bf16.cuh
// instead, on bf16 planes split once.

#pragma once

#include <cuda_runtime.h>

namespace tn {

// The precision codes the C entry points take (precision.py CODES).
enum Precision { kHighest = 0, kHigh = 1, kDefault = 2 };

namespace mma {

// bf16x2 of (x0, x1), each rounded to nearest even, x0 in the low half.
__device__ __forceinline__ unsigned bf16x2(float x0, float x1) {
  unsigned r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(x1), "f"(x0));
  return r;
}
__device__ __forceinline__ float low_f32(unsigned v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float high_f32(unsigned v) { return __uint_as_float(v & 0xffff0000u); }
__device__ __forceinline__ unsigned neg(unsigned v) { return v ^ 0x80008000u; }

// hi of (x0, x1), and for kHigh lo, the bf16 of the exact FP32 remainder.
template <int P>
__device__ __forceinline__ void split(float x0, float x1, unsigned& hi, unsigned& lo) {
  hi = bf16x2(x0, x1);
  if constexpr (P == kHigh) lo = bf16x2(x0 - low_f32(hi), x1 - high_f32(hi));
  else lo = 0u;
}

// x as the products of precision P see it against an exact operand: bf16_rn(x)
// for kDefault, hi + lo for kHigh (the forward's closed-form first phase).
template <int P>
__device__ __forceinline__ float operand(float x) {
  unsigned hi, lo;
  split<P>(x, 0.f, hi, lo);
  return P == kHigh ? low_f32(hi) + low_f32(lo) : low_f32(hi);
}

// One plane's fragments: hi, and lo for kHigh.
struct FragA { unsigned hi[4], lo[4]; };
struct FragB { unsigned hi[2], lo[2]; };

__device__ __forceinline__ int lane_g() { return (threadIdx.x & 31) >> 2; }
__device__ __forceinline__ int lane_t() { return threadIdx.x & 3; }

// The A fragment (16 rows x 16 k) at rows m0.. of a k-major FP32 plane
// a[k * ld + m], k from 0: registers (g, 2t..), (g+8, 2t..), (g, 2t+8..),
// (g+8, 2t+8..), g = lane / 4, t = lane % 4.
template <int P>
__device__ __forceinline__ void load_a(const float* a, int ld, int m0, FragA& f) {
  const float* p = a + m0 + lane_g() + 2 * lane_t() * ld;
  split<P>(p[0], p[ld], f.hi[0], f.lo[0]);
  split<P>(p[8], p[ld + 8], f.hi[1], f.lo[1]);
  split<P>(p[8 * ld], p[9 * ld], f.hi[2], f.lo[2]);
  split<P>(p[8 * ld + 8], p[9 * ld + 8], f.hi[3], f.lo[3]);
}

// The B fragment (16 k x 8 columns) at columns n0.. of a k-major FP32 plane
// b[k * ld + n]: registers (k 2t.., column g), (k 2t+8.., column g).
template <int P>
__device__ __forceinline__ void load_b(const float* b, int ld, int n0, FragB& f) {
  const float* p = b + n0 + lane_g() + 2 * lane_t() * ld;
  split<P>(p[0], p[ld], f.hi[0], f.lo[0]);
  split<P>(p[8 * ld], p[9 * ld], f.hi[1], f.lo[1]);
}

__device__ __forceinline__ void mma16816(float (&d)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a (sb b) at precision P, sb = -1 when NEG (B's two registers are
// negated, not A's four): the lo terms first.
template <int P, bool NEG>
__device__ __forceinline__ void real_product(float (&d)[4], const FragA& a, const FragB& b) {
  unsigned bh[2], bl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    bh[i] = NEG ? neg(b.hi[i]) : b.hi[i];
    bl[i] = NEG ? neg(b.lo[i]) : b.lo[i];
  }
  if constexpr (P == kHigh) {
    mma16816(d, a.lo, bh);
    mma16816(d, a.hi, bl);
  }
  mma16816(d, a.hi, bh);
}

// One k16 step of a complex product into the accumulator tiles (re, im),
// elements (g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1) of the 16 x 8 tile:
//   re += ar br - (ca cb) ai bi;   im += ar (cb bi) + (ca ai) br,
// ca / cb = -1 for a conjugated A / B, each sign carried by B's fragments:
// (ca ai) br = ai (ca br).
// The step's passes are summed from zero on the tensor cores and added to
// the accumulators by FADD, rounded to nearest, re's then im's (one
// four-register sum live at a time). The tensor cores' FP32 accumulation
// aligns and truncates its addends, a bias that, accumulated over the whole
// of K in one mma chain, grew linearly with K: under `high` it read 1.9e-5,
// 7.4e-5 and 3.5e-4 of float64 at K = 256, 1024 and 4096 against 1.8e-5,
// 2.8e-5 and 3.3e-5 for the same passes summed by cuBLAS (an H100,
// PERF.md).
template <int P, bool CA, bool CB>
__device__ __forceinline__ void complex_product(float (&re)[4], float (&im)[4], const FragA& ar,
                                                const FragA& ai, const FragB& br,
                                                const FragB& bi) {
  float s[4] = {0.f, 0.f, 0.f, 0.f};
  real_product<P, false>(s, ar, br);
  real_product<P, CA == CB>(s, ai, bi);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    re[e] += s[e];
    s[e] = 0.f;
  }
  real_product<P, CB>(s, ar, bi);
  real_product<P, CA>(s, ai, br);
#pragma unroll
  for (int e = 0; e < 4; ++e) im[e] += s[e];
}

}  // namespace mma
}  // namespace tn
