// The tiled FP32 complex GEMMs on planar (re, im) operands of the n >= 18
// circuit launchers (circuit_layers.cuh), with an epilogue that can scatter
// through a layer's index map and CZ sign (layer_map.cuh).
//
// Every product computes, for every batch b,
//     C_b[m, n] = sum_k opA(A_b)[m, k] * opB(B_b)[k, n]
// where every operand is addressed through explicit strides, so transposes
// are free, and the imaginary part of A or B may be negated on load, so
// conjugates are free.
//
// The products replace the dots inside the TPU kernels of
// tensornetworks_tpu/ops/pallas/circuit2d_grid.py (fwd_kernel, bwd_kernel);
// the n <= 17 kernels have work units of their own (circuit_units.cuh).
// Their bound on this card
// is FP32 FMA throughput, 67 TFLOP/s: at n=20 a complex 1024^3 product is
// 8.6 GFLOP (128 us) against 24 MB of operands (7 us at 3.35 TB/s). That is
// the default precision, `highest`, and its FMA loops below. Under the
// kernel precision `default` (one bf16 pass) and `high` (three), the circuit
// launchers (circuit_layers.cuh) send every product of the large loop's
// shapes (large::pattern) to the TMA + wgmma loop of wgmma_bf16.cuh; the
// smaller ones (n = 18, and at n = 19 the forward and dMc) run gemm_kernel
// with its FMA block replaced by bf16 mma.sync products on the tensor cores
// (mma_bf16.cuh; 989 TFLOP/s dense), on the same shared-memory stage and
// with the same epilogues; its template parameter P picks the instantiation.
// The large loop has the FP32 instantiations only.
//
// Two main loops, chosen by shape in launch_gemm:
//
// gemm_kernel (every product with fewer than 128 tiles of 128x64, so at
// n = 18-19): BMxBN tiles of 64x64 or 32x32, one synchronous shared-memory
// stage, a 4x4 or 2x2 register tile, scalar shared-memory reads. At n=20 it
// reached 24 TFLOP/s (36% of peak) on the grid backward: no copy overlaps the
// FMAs, and a 4x4 complex tile makes 4 FMAs per shared-memory load.
//
// cgemm_large_kernel (FP32 only; complex, M % 128 == 0, N % 64 == 0, K % 16
// == 0, at least 128 tiles: the n >= 19 circuit backward and forward-left
// products, and from n = 20 the forward's scatter product; a bf16 product of
// these shapes takes gemm_kernel should it reach launch_gemm, which the
// circuit launchers do not let happen): tiles of 128x64x16, 256
// threads with an 8x4 complex register tile each (rows ty*4..+3 and
// 64+ty*4..+3, columns tx*4..+3), which makes 128 FMAs per six float4
// shared-memory reads (5.3 FMAs per loaded float). A three-stage ring in
// dynamic shared memory (72 KB) overlaps the copy of tile k+2 with the FMAs
// of tile k. The loader is templated on the operand's layout:
//   - m-contiguous A and n-contiguous B go by 16-byte cp.async.cg straight
//     into the k-major tile;
//   - k-contiguous A or B (a cp.async cannot transpose) is read as float4
//     into registers before the FMAs of tile k and stored transposed, as
//     four scalars, after them; lanes walk m (or n) so each store hits 32
//     banks.
//   | product                      | A              | B              |
//   | col pull-back (backward)     | k-contiguous   | n-contiguous   |
//   | dMc (backward)               | m-contiguous   | n-contiguous   |
//   | row pull-back Mr^H (bwd)     | m-contiguous   | n-contiguous   |
//   | dMr x^H (backward)           | k-contiguous   | k-contiguous   |
//   | left Mr X (forward)          | k-contiguous   | n-contiguous   |
//   | right X Mc^T, scatter (fwd)  | k-contiguous   | n-contiguous   |
// The forward's right product reads B = Mc^T: the grid forward first writes
// Mc^T into a scratch (one tiled transpose, 64 MB moved at n=20) so that B
// is n-contiguous and goes by cp.async, with the left product's layout,
// instead of through the transposing loader that costs the k-contiguous
// instantiations 147-151 registers. Conjugation is a
// compile-time sign on the imaginary plane (a negated FMA operand, free). A
// 1024^2 output has 128 tiles of 128x64, one per SM of the 132; 128x128
// tiles would leave half the SMs idle on dMc and dMr, and grouping dMc with
// the row pull-back (128 + 256 tiles) would still take three waves, so
// neither is done. The n = 18-19 scatter products (32 and 64 tiles) keep
// the first loop and its configuration.
//
// Scatter epilogue (the circuit forward's right product, both loops):
// element (m, n) -- flat state index m*N + n -- goes to the index
// d = perm_dst(m*N + n), multiplied by the CZ sign there, and |C|^2 also goes
// to `probs[d]` when it is given (the last layer). In the large loop the map
// is split: N is a power of two and n < N, so m*N + n = (m*N) | n, and the
// CNOT map is GF(2)-linear, so dst(m*N + n) = dst(m*N) ^ dst(n). A thread
// evaluates perm_dst 8 + 4 times for its 8x4 tile, not 32 times; the sign is
// quadratic in d and is evaluated for each element (about 2% of the tile's
// FMAs at n=20). The stores lose their float4 form and scatter over the
// whole state; the 8 MB state stays in the 50 MB L2 between a layer's two
// products, so the scattered stores and the next left product's reads meet
// in L2, not in HBM.

#pragma once

#include <cuda_runtime.h>

#include "layer_map.cuh"
#include "mma_bf16.cuh"
#include "per_device.cuh"

namespace tn {

struct GemmArgs {
  const float* a_re; const float* a_im; long long a_sb, a_sm, a_sk;
  const float* b_re; const float* b_im; long long b_sb, b_sk, b_sn;
  float* c_re; float* c_im; long long c_sb, c_sm, c_sn;
  int M, N, K, batch;
  float a_conj, b_conj;  // factor on the imaginary part of A / B: 1 or -1
  int scatter;           // 1: epilogue writes through the PermSpec (batch 1)
  float* probs;          // scatter mode: optional |C|^2 output
};

// P (precision): kHighest, the FMA block; else 8 warps of bf16 mma tiles,
// 2 x 4 warps over the block's tile (BK = 16, one mma step a stage).
template <int BM, int BN, int BK, int TM, int TN, int P = kHighest>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
gemm_kernel(GemmArgs p, PermSpec spec) {
  constexpr int NT = (BM / TM) * (BN / TN);
  constexpr int WM = BM / 2, WN = BN / 4, FM = WM / 16, FN = WN / 8;  // mma warp tiles
  static_assert(P == kHighest || (NT == 256 && BK == 16 && FM >= 1 && FN >= 1),
                "the mma path takes 8 warps and 16-deep stages");
  constexpr int TX = BN / TN;  // threads along n
  constexpr int TY = BM / TM;  // threads along m
  __shared__ float As_re[BK][BM + 1];
  __shared__ float As_im[BK][BM + 1];
  __shared__ float Bs_re[BK][BN + 1];
  __shared__ float Bs_im[BK][BN + 1];

  const int b = blockIdx.z;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;

  const float* Ar = p.a_re + b * p.a_sb;
  const float* Ai = p.a_im + b * p.a_sb;
  const float* Br = p.b_re + b * p.b_sb;
  const float* Bi = p.b_im + b * p.b_sb;
  const bool a_kfast = p.a_sk == 1;
  const bool b_nfast = p.b_sn == 1;

  float acc_re[TM][TN];
  float acc_im[TM][TN];
  float mre[FM][FN][4], mim[FM][FN][4];
  const int wm = (tid / 32) % 2, wn = tid / 64;
  if constexpr (P == kHighest) {
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) { acc_re[i][j] = 0.f; acc_im[i][j] = 0.f; }
  } else {
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int j = 0; j < FN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) { mre[i][j][e] = 0.f; mim[i][j][e] = 0.f; }
  }

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
        vi = p.a_conj * Ai[off];
      }
      As_re[kk][mm] = vr;
      As_im[kk][mm] = vi;
    }
    for (int e = tid; e < BK * BN; e += NT) {
      const int nn = b_nfast ? e % BN : e / BK;
      const int kk = b_nfast ? e / BN : e % BK;
      const int n = n0 + nn, k = k0 + kk;
      float vr = 0.f, vi = 0.f;
      if (n < p.N && k < p.K) {
        const long long off = (long long)k * p.b_sk + (long long)n * p.b_sn;
        vr = Br[off];
        vi = p.b_conj * Bi[off];
      }
      Bs_re[kk][nn] = vr;
      Bs_im[kk][nn] = vi;
    }
    __syncthreads();
    if constexpr (P != kHighest) {
      // The a_conj / b_conj signs were applied on load, so no conjugation here.
      mma::FragB br[FN], bi[FN];
#pragma unroll
      for (int j = 0; j < FN; ++j) {
        mma::load_b<P>(&Bs_re[0][0], BN + 1, wn * WN + 8 * j, br[j]);
        mma::load_b<P>(&Bs_im[0][0], BN + 1, wn * WN + 8 * j, bi[j]);
      }
#pragma unroll
      for (int i = 0; i < FM; ++i) {
        mma::FragA ar, ai;
        mma::load_a<P>(&As_re[0][0], BM + 1, wm * WM + 16 * i, ar);
        mma::load_a<P>(&As_im[0][0], BM + 1, wm * WM + 16 * i, ai);
#pragma unroll
        for (int j = 0; j < FN; ++j)
          mma::complex_product<P, false, false>(mre[i][j], mim[i][j], ar, ai, br[j], bi[j]);
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        float ar[TM], ai[TM], br[TN], bi[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          ar[i] = As_re[kk][ty + i * TY];
          ai[i] = As_im[kk][ty + i * TY];
        }
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          br[j] = Bs_re[kk][tx + j * TX];
          bi[j] = Bs_im[kk][tx + j * TX];
        }
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) {
            acc_re[i][j] = fmaf(ar[i], br[j], acc_re[i][j]);
            acc_re[i][j] = fmaf(-ai[i], bi[j], acc_re[i][j]);
            acc_im[i][j] = fmaf(ar[i], bi[j], acc_im[i][j]);
            acc_im[i][j] = fmaf(ai[i], br[j], acc_im[i][j]);
          }
      }
    }
    __syncthreads();
  }

  if constexpr (P != kHighest) {
    const int g = mma::lane_g(), t = mma::lane_t();
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int j = 0; j < FN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int m = m0 + wm * WM + 16 * i + g + (e >= 2 ? 8 : 0);
          const int n = n0 + wn * WN + 8 * j + 2 * t + (e & 1);
          if (m >= p.M || n >= p.N) continue;
          const float vr = mre[i][j][e], vi = mim[i][j][e];
          if (p.scatter) {
            const unsigned d = perm_dst(spec, (unsigned)(m * p.N + n));
            const float s = perm_sign(spec, d);
            p.c_re[d] = s * vr;
            p.c_im[d] = s * vi;
            if (p.probs) p.probs[d] = vr * vr + vi * vi;
          } else {
            const long long off = b * p.c_sb + (long long)m * p.c_sm + (long long)n * p.c_sn;
            p.c_re[off] = vr;
            p.c_im[off] = vi;
          }
        }
  } else {
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
          p.c_im[d] = s * vi;
          if (p.probs) p.probs[d] = vr * vr + vi * vi;
        } else {
          const long long off = b * p.c_sb + (long long)m * p.c_sm + (long long)n * p.c_sn;
          p.c_re[off] = vr;
          p.c_im[off] = vi;
        }
      }
  }
}

template <int BM, int BN, int BK, int TM, int TN, int P>
inline cudaError_t launch_gemm_cfg(const GemmArgs& p, const PermSpec& s, cudaStream_t st) {
  dim3 grid((p.N + BN - 1) / BN, (p.M + BM - 1) / BM, p.batch);
  gemm_kernel<BM, BN, BK, TM, TN, P><<<grid, (BM / TM) * (BN / TN), 0, st>>>(p, s);
  return cudaGetLastError();
}

// ----------------------------------------------------------------- large loop

namespace large {

constexpr int BM = 128, BN = 64, BK = 16, STAGES = 3, THREADS = 256;
constexpr int A_PLANE = BK * BM, B_PLANE = BK * BN;
constexpr int STAGE = 2 * A_PLANE + 2 * B_PLANE;  // floats: A re, A im, B re, B im
constexpr size_t SMEM = STAGES * STAGE * sizeof(float);

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// One operand's tile loader. ROWS x BK values per plane (ROWS = BM for A,
// BN for B), stored k-major: tile[k * ROWS + r]. `base` points at the
// operand's (row 0 of the block, k 0) element of each plane; `s_row` and
// `s_k` are its strides. KC: the operand is k-contiguous (s_k == 1).
template <int ROWS, bool KC>
struct Loader {
  static constexpr int PER_PLANE = ROWS * BK / 4 / THREADS;  // float4 per thread and plane
  static constexpr int CHUNKS = 2 * PER_PLANE;
  static_assert(PER_PLANE * THREADS * 4 == ROWS * BK, "tile must split evenly");
  float4 reg[KC ? CHUNKS : 1];

  // KC == false: cp.async of the tile at k0 into `tile` (2 planes).
  // KC == true: global float4 loads into registers.
  __device__ __forceinline__ void issue(const float* const base[2], long long s_row,
                                        long long s_k, int k0, float* tile) {
#pragma unroll
    for (int i = 0; i < CHUNKS; ++i) {
      const int plane = i / PER_PLANE;
      const int r = threadIdx.x + (i % PER_PLANE) * THREADS;
      if (KC) {  // lanes walk the rows; each takes four consecutive k
        const int row = r % ROWS, kq = r / ROWS;
        reg[i] = __ldg(reinterpret_cast<const float4*>(base[plane] + row * s_row + k0 + 4 * kq));
      } else {   // lanes walk the contiguous rows dimension at one k
        const int k = r / (ROWS / 4), rq = r % (ROWS / 4);
        cp_async16(tile + plane * (ROWS * BK) + k * ROWS + 4 * rq,
                   base[plane] + (long long)(k0 + k) * s_k + 4 * rq);
      }
    }
  }

  // KC == true: the transposing store of the registers into `tile`.
  __device__ __forceinline__ void store(float* tile) {
    if (!KC) return;
#pragma unroll
    for (int i = 0; i < CHUNKS; ++i) {
      const int plane = i / PER_PLANE;
      const int r = threadIdx.x + (i % PER_PLANE) * THREADS;
      const int row = r % ROWS, kq = r / ROWS;
      float* t = tile + plane * (ROWS * BK) + 4 * kq * ROWS + row;
      t[0] = reg[i].x;
      t[ROWS] = reg[i].y;
      t[2 * ROWS] = reg[i].z;
      t[3 * ROWS] = reg[i].w;
    }
  }
};

// AK / BKC: A / B is k-contiguous; CA / CB: conjugate A / B; SCATTER: the
// epilogue sends each element through `spec` (batch 1), see the note above.
// The scatter instantiation names one block per SM as its occupancy target:
// left to its own heuristic, ptxas capped it at 128 registers and spilled 16
// bytes, and its product ran 0.1 ms slower over the n=20 forward's four
// (PERF.md); the other instantiations keep the target they had (0: none).
template <bool AK, bool BKC, bool CA, bool CB, bool SCATTER>
__global__ void __launch_bounds__(THREADS, SCATTER ? 1 : 0)
    cgemm_large_kernel(GemmArgs p, PermSpec spec) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.z, m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const long long a_off = b * p.a_sb + (long long)m0 * p.a_sm;
  const long long b_off = b * p.b_sb + (long long)n0 * p.b_sn;
  const float* const a_base[2] = {p.a_re + a_off, p.a_im + a_off};
  const float* const b_base[2] = {p.b_re + b_off, p.b_im + b_off};
  Loader<BM, AK> la;
  Loader<BN, BKC> lb;

  float acc_re[8][4], acc_im[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) { acc_re[i][j] = 0.f; acc_im[i][j] = 0.f; }

  const int nk = p.K / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) {
      float* const at = smem + s * STAGE;
      la.issue(a_base, p.a_sm, p.a_sk, s * BK, at);
      lb.issue(b_base, p.b_sn, p.b_sk, s * BK, at + 2 * A_PLANE);
      la.store(at);
      lb.store(at + 2 * A_PLANE);
    }
    cp_async_commit();
  }

  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // tile kt is in; every thread is done with tile kt-1
    const int nt = kt + STAGES - 1;
    const bool more = nt < nk;
    float* const next = smem + (nt % STAGES) * STAGE;  // the stage tile kt-1 held
    if (more) {
      la.issue(a_base, p.a_sm, p.a_sk, nt * BK, next);
      lb.issue(b_base, p.b_sn, p.b_sk, nt * BK, next + 2 * A_PLANE);
    }
    cp_async_commit();

    const float* As = smem + (kt % STAGES) * STAGE;
    const float* Bs = As + 2 * A_PLANE;
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float* ar_k = As + kk * BM;
      const float* ai_k = As + A_PLANE + kk * BM;
      const float4 a0r = *reinterpret_cast<const float4*>(ar_k + 4 * ty);
      const float4 a1r = *reinterpret_cast<const float4*>(ar_k + 64 + 4 * ty);
      const float4 a0i = *reinterpret_cast<const float4*>(ai_k + 4 * ty);
      const float4 a1i = *reinterpret_cast<const float4*>(ai_k + 64 + 4 * ty);
      const float4 b4r = *reinterpret_cast<const float4*>(Bs + kk * BN + 4 * tx);
      const float4 b4i = *reinterpret_cast<const float4*>(Bs + B_PLANE + kk * BN + 4 * tx);
      const float ar[8] = {a0r.x, a0r.y, a0r.z, a0r.w, a1r.x, a1r.y, a1r.z, a1r.w};
      const float ai[8] = {a0i.x, a0i.y, a0i.z, a0i.w, a1i.x, a1i.y, a1i.z, a1i.w};
      const float br[4] = {b4r.x, b4r.y, b4r.z, b4r.w};
      const float bi[4] = {b4i.x, b4i.y, b4i.z, b4i.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          // re += ar br - (ca cb) ai bi;  im += cb ar bi + ca ai br
          acc_re[i][j] = fmaf(ar[i], br[j], acc_re[i][j]);
          acc_re[i][j] = fmaf(CA != CB ? ai[i] : -ai[i], bi[j], acc_re[i][j]);
          acc_im[i][j] = fmaf(CB ? -ar[i] : ar[i], bi[j], acc_im[i][j]);
          acc_im[i][j] = fmaf(CA ? -ai[i] : ai[i], br[j], acc_im[i][j]);
        }
    }
    if (more) {  // the transposing loaders' stores, after the FMAs they overlapped
      la.store(next);
      lb.store(next + 2 * A_PLANE);
    }
  }

  if constexpr (SCATTER) {
    unsigned dn[4];  // dst of the column part of the flat index
#pragma unroll
    for (int j = 0; j < 4; ++j) dn[j] = perm_dst(spec, (unsigned)(n0 + 4 * tx + j));
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int m = m0 + (i < 4 ? 4 * ty + i : 64 + 4 * ty + i - 4);
      const unsigned dm = perm_dst(spec, (unsigned)m * (unsigned)p.N);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const unsigned d = dm ^ dn[j];
        const float s = perm_sign(spec, d), vr = acc_re[i][j], vi = acc_im[i][j];
        p.c_re[d] = s * vr;
        p.c_im[d] = s * vi;
        if (p.probs) p.probs[d] = vr * vr + vi * vi;
      }
    }
  } else {
    const long long c_off = b * p.c_sb + (long long)n0 + 4 * tx;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int m = m0 + (i < 4 ? 4 * ty + i : 64 + 4 * ty + i - 4);
      const long long off = c_off + (long long)m * p.c_sm;
      *reinterpret_cast<float4*>(p.c_re + off) =
          make_float4(acc_re[i][0], acc_re[i][1], acc_re[i][2], acc_re[i][3]);
      *reinterpret_cast<float4*>(p.c_im + off) =
          make_float4(acc_im[i][0], acc_im[i][1], acc_im[i][2], acc_im[i][3]);
    }
  }
}

template <bool AK, bool BKC, bool CA, bool CB, bool SCATTER>
inline cudaError_t launch(const GemmArgs& p, const PermSpec& s, cudaStream_t st) {
  static PerDevice<cudaError_t> attrs;
  const cudaError_t* attr = attrs.get([] {
    return cudaFuncSetAttribute(cgemm_large_kernel<AK, BKC, CA, CB, SCATTER>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
  });
  if (!attr) return cudaErrorInvalidDevice;
  if (*attr != cudaSuccess) return *attr;
  dim3 grid(p.N / BN, p.M / BM, p.batch);
  cgemm_large_kernel<AK, BKC, CA, CB, SCATTER><<<grid, THREADS, SMEM, st>>>(p, s);
  return cudaGetLastError();
}

inline bool aligned16(const void* q) { return ((unsigned long long)q & 15ull) == 0; }

// Which instantiation of the large loop takes this product, or kNone for a
// shape, layout or conjugation pattern it does not cover. The patterns are
// those of the circuit launchers (circuit_layers.cuh).
enum Pattern { kNone = -1, kColPullback, kDMc, kRowPullback, kDMr, kForwardLeft,
               kForwardScatter };

inline Pattern pattern(const GemmArgs& p) {
  if (p.M % BM || p.N % BN || p.K % BK) return kNone;
  if ((long long)(p.M / BM) * (p.N / BN) * p.batch < 128) return kNone;
  const bool ak = p.a_sk == 1, am = p.a_sm == 1, bk = p.b_sk == 1, bn = p.b_sn == 1;
  if (!(ak || am) || !(bk || bn) || (p.c_sn != 1 && !p.scatter)) return kNone;
  const long long strides[] = {p.a_sb, ak ? p.a_sm : p.a_sk, p.b_sb, bk ? p.b_sn : p.b_sk,
                               p.c_sb, p.c_sm};
  for (long long s : strides)
    if (s % 4) return kNone;
  const void* ptrs[] = {p.a_re, p.a_im, p.b_re, p.b_im, p.c_re, p.c_im};
  for (const void* q : ptrs)
    if (!aligned16(q)) return kNone;
  const bool ca = p.a_conj < 0, cb = p.b_conj < 0;
  if (p.scatter) return (ak && bn && !ca && !cb && p.batch == 1) ? kForwardScatter : kNone;
  if (ak && bn && !ca && cb) return kColPullback;
  if (am && bn && !ca && cb) return kDMc;
  if (am && bn && ca && !cb) return kRowPullback;
  if (ak && bk && !ca && cb) return kDMr;
  if (ak && bn && !ca && !cb) return kForwardLeft;
  return kNone;
}

}  // namespace large

// FP32 products with at least 128 tiles of 128x64 take the large loop.
// Otherwise, and at the bf16 precisions: 64x64 tiles when they alone give at
// least one block per SM (132 on an H100), else 32x32 tiles so that a single
// 256x256 product still spreads over 64 SMs.
template <int P>
inline cudaError_t launch_gemm_at(const GemmArgs& p, const PermSpec& s, cudaStream_t st) {
  if constexpr (P == kHighest) {
    switch (large::pattern(p)) {
      case large::kColPullback: return large::launch<true, false, false, true, false>(p, s, st);
      case large::kDMc: return large::launch<false, false, false, true, false>(p, s, st);
      case large::kRowPullback: return large::launch<false, false, true, false, false>(p, s, st);
      case large::kDMr: return large::launch<true, true, false, true, false>(p, s, st);
      case large::kForwardLeft: return large::launch<true, false, false, false, false>(p, s, st);
      case large::kForwardScatter: return large::launch<true, false, false, false, true>(p, s, st);
      case large::kNone: break;
    }
  }
  const long long big = (long long)((p.N + 63) / 64) * ((p.M + 63) / 64) * p.batch;
  if (big >= 132) return launch_gemm_cfg<64, 64, 16, 4, 4, P>(p, s, st);
  return launch_gemm_cfg<32, 32, 16, 2, 2, P>(p, s, st);
}

// The instantiation of `precision` (a Precision code); an unknown code is
// refused, nothing launched.
inline cudaError_t launch_gemm(const GemmArgs& p, const PermSpec& s, cudaStream_t st,
                               int precision) {
  switch (precision) {
    case kHighest: return launch_gemm_at<kHighest>(p, s, st);
    case kHigh: return launch_gemm_at<kHigh>(p, s, st);
    case kDefault: return launch_gemm_at<kDefault>(p, s, st);
  }
  return cudaErrorInvalidValue;
}

inline GemmArgs gemm_args() {
  GemmArgs p = {};
  p.a_conj = 1.f;
  p.b_conj = 1.f;
  p.batch = 1;
  return p;
}

}  // namespace tn
