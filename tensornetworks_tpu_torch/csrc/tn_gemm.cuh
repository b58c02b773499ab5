// Shared device code of the port's hand-written kernels: a tiled FP32
// (complex or real) GEMM on planar (re, im) operands, and the GF(2)-linear
// index map with its CZ sign that the circuit kernels use for a layer's CNOT
// permutations and CZ gates.
//
// The GEMM computes, for every batch b,
//     C_b[m, n] = sum_k opA(A_b)[m, k] * opB(B_b)[k, n]
// where every operand is addressed through explicit strides, so transposes
// are free, and the imaginary part of A or B may be negated on load, so
// conjugates are free. Tiles are staged through shared memory; each thread
// accumulates a TM x TN block of outputs in registers. FP32 FMA only: the
// tensor cores would need TF32 or lower, which the port does not allow.
//
// The epilogue either stores C through its strides, or (scatter mode, used by
// the circuit forward) sends element (m, n) -- flat state index m*N + n -- to
// the index perm_dst(i), multiplied by the CZ sign there, and optionally
// writes |C|^2 to `probs` at the same index.

#pragma once

#include <cuda_runtime.h>

namespace tn {

constexpr int kMaxBits = 32;

// One layer's composite permutation of the flat state index with its sign.
// Bit k below is the LSB-first bit position k of the index.
//   dst(i) bit k = parity(rows[k] & i)            (CNOT chain: GF(2)-linear)
//   sign(d)      = (-1)^(sum_k bit_k(d) * popc(d & cz[k]))   (CZ pairs)
struct PermSpec {
  int nbits;
  unsigned rows[kMaxBits];
  unsigned cz[kMaxBits];
};

__device__ __forceinline__ unsigned perm_dst(const PermSpec& s, unsigned i) {
  unsigned d = 0;
  for (int k = 0; k < s.nbits; ++k) d |= (unsigned)(__popc(s.rows[k] & i) & 1) << k;
  return d;
}

__device__ __forceinline__ float perm_sign(const PermSpec& s, unsigned d) {
  unsigned par = 0;
  for (int k = 0; k < s.nbits; ++k) par ^= ((d >> k) & 1u) & (unsigned)__popc(d & s.cz[k]);
  return (par & 1u) ? -1.f : 1.f;
}

struct GemmArgs {
  const float* a_re; const float* a_im; long long a_sb, a_sm, a_sk;
  const float* b_re; const float* b_im; long long b_sb, b_sk, b_sn;
  float* c_re; float* c_im; long long c_sb, c_sm, c_sn;
  int M, N, K, batch;
  float a_conj, b_conj;  // factor on the imaginary part of A / B: 1 or -1
  int scatter;           // 1: epilogue writes through the PermSpec (batch 1)
  float* probs;          // scatter mode: optional |C|^2 output
};

template <int BM, int BN, int BK, int TM, int TN, bool CPLX>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
gemm_kernel(GemmArgs p, PermSpec spec) {
  constexpr int NT = (BM / TM) * (BN / TN);
  constexpr int TX = BN / TN;  // threads along n
  constexpr int TY = BM / TM;  // threads along m
  constexpr int IM = CPLX ? 1 : 0;
  __shared__ float As_re[BK][BM + 1];
  __shared__ float As_im[CPLX ? BK : 1][CPLX ? BM + 1 : 1];
  __shared__ float Bs_re[BK][BN + 1];
  __shared__ float Bs_im[CPLX ? BK : 1][CPLX ? BN + 1 : 1];

  const int b = blockIdx.z;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;

  const float* Ar = p.a_re + b * p.a_sb;
  const float* Ai = IM ? p.a_im + b * p.a_sb : nullptr;
  const float* Br = p.b_re + b * p.b_sb;
  const float* Bi = IM ? p.b_im + b * p.b_sb : nullptr;
  const bool a_kfast = p.a_sk == 1;
  const bool b_nfast = p.b_sn == 1;

  float acc_re[TM][TN];
  float acc_im[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) { acc_re[i][j] = 0.f; acc_im[i][j] = 0.f; }

  for (int k0 = 0; k0 < p.K; k0 += BK) {
    // Stage the A and B tiles; consecutive threads walk the operand's
    // contiguous dimension so that the global loads coalesce.
    for (int e = tid; e < BM * BK; e += NT) {
      const int mm = a_kfast ? e / BK : e % BM;
      const int kk = a_kfast ? e % BK : e / BM;
      const int m = m0 + mm, k = k0 + kk;
      float vr = 0.f, vi = 0.f;
      if (m < p.M && k < p.K) {
        const long long off = (long long)m * p.a_sm + (long long)k * p.a_sk;
        vr = Ar[off];
        if (CPLX) vi = p.a_conj * Ai[off];
      }
      As_re[kk][mm] = vr;
      if (CPLX) As_im[kk][mm] = vi;
    }
    for (int e = tid; e < BK * BN; e += NT) {
      const int nn = b_nfast ? e % BN : e / BK;
      const int kk = b_nfast ? e / BN : e % BK;
      const int n = n0 + nn, k = k0 + kk;
      float vr = 0.f, vi = 0.f;
      if (n < p.N && k < p.K) {
        const long long off = (long long)k * p.b_sk + (long long)n * p.b_sn;
        vr = Br[off];
        if (CPLX) vi = p.b_conj * Bi[off];
      }
      Bs_re[kk][nn] = vr;
      if (CPLX) Bs_im[kk][nn] = vi;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float ar[TM], ai[TM], br[TN], bi[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        ar[i] = As_re[kk][ty + i * TY];
        ai[i] = CPLX ? As_im[kk][ty + i * TY] : 0.f;
      }
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        br[j] = Bs_re[kk][tx + j * TX];
        bi[j] = CPLX ? Bs_im[kk][tx + j * TX] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          acc_re[i][j] = fmaf(ar[i], br[j], acc_re[i][j]);
          if (CPLX) {
            acc_re[i][j] = fmaf(-ai[i], bi[j], acc_re[i][j]);
            acc_im[i][j] = fmaf(ar[i], bi[j], acc_im[i][j]);
            acc_im[i][j] = fmaf(ai[i], br[j], acc_im[i][j]);
          }
        }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int m = m0 + ty + i * TY;
      const int n = n0 + tx + j * TX;
      if (m >= p.M || n >= p.N) continue;
      const float vr = acc_re[i][j], vi = acc_im[i][j];
      if (p.scatter) {
        const unsigned d = perm_dst(spec, (unsigned)(m * p.N + n));
        const float s = perm_sign(spec, d);
        p.c_re[d] = s * vr;
        if (CPLX) p.c_im[d] = s * vi;
        if (p.probs) p.probs[d] = vr * vr + vi * vi;
      } else {
        const long long off = b * p.c_sb + (long long)m * p.c_sm + (long long)n * p.c_sn;
        p.c_re[off] = vr;
        if (CPLX) p.c_im[off] = vi;
      }
    }
}

template <int BM, int BN, int BK, int TM, int TN, bool CPLX>
inline cudaError_t launch_gemm_cfg(const GemmArgs& p, const PermSpec& s, cudaStream_t st) {
  dim3 grid((p.N + BN - 1) / BN, (p.M + BM - 1) / BM, p.batch);
  gemm_kernel<BM, BN, BK, TM, TN, CPLX><<<grid, (BM / TM) * (BN / TN), 0, st>>>(p, s);
  return cudaGetLastError();
}

// 64x64 tiles when they alone give at least one block per SM (132 on an
// H100), else 32x32 tiles so that a single 256x256 product still spreads
// over 64 SMs.
template <bool CPLX>
inline cudaError_t launch_gemm(const GemmArgs& p, const PermSpec& s, cudaStream_t st) {
  const long long big = (long long)((p.N + 63) / 64) * ((p.M + 63) / 64) * p.batch;
  if (big >= 132) return launch_gemm_cfg<64, 64, 16, 4, 4, CPLX>(p, s, st);
  return launch_gemm_cfg<32, 32, 16, 2, 2, CPLX>(p, s, st);
}

inline GemmArgs gemm_args() {
  GemmArgs p = {};
  p.a_conj = 1.f;
  p.b_conj = 1.f;
  p.batch = 1;
  return p;
}

}  // namespace tn
