// The work units of the two persistent n <= 17 circuit kernels
// (circuit2d_fwd.cuh, circuit2d_bwd.cuh), FP32 on planar (re, im) planes, for
// sm_90a, and their cooperative launch.
//
// A persistent kernel runs one block of 256 threads on every SM (every block
// resident, which the cooperative launch checks; one block per SM even where
// the occupancy calculator would allow more, because a phase holds about one
// unit of work per SM and further blocks would only wait at the barriers
// while leaving the spread of units over SMs to the block scheduler). Its
// phases are separated by grid-wide barriers (cooperative_groups grid sync),
// and every buffer it touches stays in the 50 MB L2.
//
// A unit is one 32 x TN output tile (TN = 32 in the backward, 16 in the
// forward) of one complex product, batch element included, computed by the
// whole block: four groups of 64 threads each take a quarter of K (whole
// 16-deep steps) for the same tile, with a 4 x TN/8 complex register tile per
// thread (4x4 in the backward: 64 FMAs per four float4 shared reads, 4 FMAs
// per loaded float; 4x2 in the forward, 2.7), and the four partial tiles are
// summed in shared memory in a fixed order (deterministic; no float
// atomics). The sum's store is plain, or, in the forward's scatter units,
// goes through a layer's index map and CZ sign (layer_map.cuh PermSpec,
// evaluated once per element) and writes |z|^2 too on the last layer. Each
// group streams its K-range from L2 through a two-stage cp.async ring: 16
// bytes a copy where the operand's contiguous dimension is the tile's m (or
// n), else 4 bytes a copy (a 4-byte copy can transpose; k-contiguous
// operands need it); out-of-range elements are zero-filled by the copy, so
// ragged tiles (n=3: R=4, C=2) and odd n (R = 2C) take the same code.
//
// Precision (template parameter P, mma_bf16.cuh): kHighest runs the FMA
// block above; kHigh and kDefault replace it with bf16 mma.sync products on
// the same ring, each group's two warps taking 16 rows x TN of the tile
// (TN / 8 tiles of 16 x 8). Their partial tiles go to the same shared-memory
// K-split sum, so the store, the scatter and its order are those of FP32.
// The bf16 units run kernel 1's `high` and `default`; kernel 2's bf16
// variants are the kernel of circuit_bf16.cuh, which reads its layer tables
// by load_spec below.
//
// Flat state indices are 32-bit, as in circuit_layers.cuh.

#pragma once

#include <cooperative_groups.h>

#include "layer_map.cuh"
#include "mma_bf16.cuh"
#include "per_device.cuh"

namespace tn {
namespace unit {

constexpr int TILE = 32, BK = 16, GROUPS = 4, GROUP_THREADS = 64;
constexpr int THREADS = GROUPS * GROUP_THREADS;
constexpr int ROW = TILE + 4;       // padded shared row (floats): keeps float4 alignment
constexpr int PLANE = BK * ROW;     // one plane of one operand tile, k-major
constexpr int STAGE = 4 * PLANE;    // A re, A im, B re, B im
constexpr int STAGES = 2;
constexpr int GROUP_FLOATS = STAGES * STAGE;
constexpr size_t SMEM = GROUPS * GROUP_FLOATS * sizeof(float);  // 73,728 bytes
static_assert(GROUPS * 2 * TILE * TILE <= GROUPS * GROUP_FLOATS, "the K-split sum reuses the ring");

// One complex product C_b = opA(A_b) opB(B_b) (c_sn = 1). vec_a / vec_b: the
// operand's tile rows (m for A, n for B) are contiguous in groups of four
// aligned floats, so it goes by 16-byte copies.
struct Prod {
  const float* a_re; const float* a_im; long long a_sb, a_sm, a_sk;
  const float* b_re; const float* b_im; long long b_sb, b_sk, b_sn;
  float* c_re; float* c_im; long long c_sb, c_sm;
  int M, N, K, batch, vec_a, vec_b;
};

template <int T = TILE>
__device__ __forceinline__ int tiles(int x) { return (x + T - 1) / T; }
template <int TN = TILE>
__device__ __forceinline__ int units(const Prod& p) {
  return p.batch * tiles(p.M) * tiles<TN>(p.N);
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem),
               "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async16(float* smem, const float* gmem, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait1() { asm volatile("cp.async.wait_group 1;\n" ::); }

// A group's copy of one operand tile: ROWS rows (m or n; 32 or 16) x BK k
// per plane, stored k-major, tile[k * ROW + row]. re / im: the planes at
// (row 0, k 0) of the tile; rows / ks: how many rows and k are in range.
// Out-of-range elements are zero-filled (their source clamped to the base).
// Each thread copies a fixed pattern -- one start and one stride per operand
// -- so that few addresses stay live across the K loop. The operand is
// either k-contiguous (s_k == 1) or row-contiguous (s_row == 1).
template <int ROWS>
__device__ __forceinline__ void load_tile(const float* re, const float* im, long long s_row,
                                          long long s_k, int rows, int ks, bool vec,
                                          float* tile, int q) {
  if (vec) {  // 16 bytes a copy: four rows at k, k + KS, ..., both planes
    constexpr int PER = ROWS / 4, KS = GROUP_THREADS / PER, IT = BK / KS;
    const int row = 4 * (q % PER), kk = q / PER;
    const long long off = row + (long long)kk * s_k;
    float* const t = tile + kk * ROW + row;
#pragma unroll
    for (int i = 0; i < IT; ++i) {
      const bool ok = row < rows && kk + KS * i < ks;
      const long long o = ok ? off + (long long)KS * i * s_k : 0;
      cp_async16(t + KS * i * ROW, re + o, ok);
      cp_async16(t + PLANE + KS * i * ROW, im + o, ok);
    }
  } else if (s_k == 1) {  // k-contiguous: lanes along k, rows row + RS i
    constexpr int RS = GROUP_THREADS / BK, IT = ROWS / RS;
    const int kk = q % BK, row = q / BK;
    const long long off = (long long)row * s_row + kk;
    float* const t = tile + kk * ROW + row;
#pragma unroll
    for (int i = 0; i < IT; ++i) {
      const bool ok = kk < ks && row + RS * i < rows;
      const long long o = ok ? off + (long long)RS * i * s_row : 0;
      cp_async4(t + RS * i, re + o, ok);
      cp_async4(t + PLANE + RS * i, im + o, ok);
    }
  } else {  // row-contiguous, ragged: lanes along the rows, k = kk + KS i
    constexpr int KS = GROUP_THREADS / ROWS, IT = BK / KS;
    const int row = q % ROWS, kk = q / ROWS;
    const long long off = row + (long long)kk * s_k;
    float* const t = tile + kk * ROW + row;
#pragma unroll
    for (int i = 0; i < IT; ++i) {
      const bool ok = row < rows && kk + KS * i < ks;
      const long long o = ok ? off + (long long)KS * i * s_k : 0;
      cp_async4(t + KS * i * ROW, re + o, ok);
      cp_async4(t + PLANE + KS * i * ROW, im + o, ok);
    }
  }
}

// Unit t of product p, by the whole block: a TILE x TN output tile. CA / CB:
// conjugate A / B. SCATTER: element (m, n) goes to d = perm_dst(*spec,
// m N + n) times the CZ sign there, and |z|^2 to probs[d] when probs is
// given (batch 1). P: the precision.
template <bool CA, bool CB, int TN = TILE, bool SCATTER = false, int P = kHighest>
__device__ void gemm_unit(const Prod& p, int t, float* smem, const PermSpec* spec = nullptr,
                          float* probs = nullptr) {
  constexpr int TNR = TN / 8;  // output columns of a thread (FP32); mma tiles of a warp
  static_assert(TNR == 4 || TNR == 2, "a unit is 32 x 32 or 32 x 16");
  const int tn_ = tiles<TN>(p.N), tm = tiles(p.M);
  const int b = t / (tm * tn_), tile = t % (tm * tn_);
  const int m0 = (tile / tn_) * TILE, n0 = (tile % tn_) * TN;
  const int grp = threadIdx.x / GROUP_THREADS, q = threadIdx.x % GROUP_THREADS;
  const int ty = q / 8, tx = q % 8;
  const int steps = (p.K + BK - 1) / BK;
  const int per = (steps + GROUPS - 1) / GROUPS;  // steps of each group (the last may run past K)
  float* const ring = smem + grp * GROUP_FLOATS;

  const long long a_off = b * p.a_sb + (long long)m0 * p.a_sm;
  const long long b_off = b * p.b_sb + (long long)n0 * p.b_sn;
  auto issue = [&](int s) {
    const int k0 = (grp * per + s) * BK, ks = p.K - k0;
    const long long kb = ks > 0 ? k0 : 0;  // a step wholly past K copies zeros from a valid base
    float* const st = ring + (s % STAGES) * STAGE;
    const long long ao = a_off + kb * p.a_sk, bo = b_off + kb * p.b_sk;
    load_tile<TILE>(p.a_re + ao, p.a_im + ao, p.a_sm, p.a_sk, p.M - m0, ks, p.vec_a, st, q);
    load_tile<TN>(p.b_re + bo, p.b_im + bo, p.b_sn, p.b_sk, p.N - n0, ks, p.vec_b,
                  st + 2 * PLANE, q);
  };

  float acc_re[4][TNR], acc_im[4][TNR];  // mma: [e][j], element e of tile j
  const int wr = 16 * ((threadIdx.x / 32) % 2);  // mma: the warp's first row
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < TNR; ++j) { acc_re[i][j] = 0.f; acc_im[i][j] = 0.f; }

  issue(0);
  cp_async_commit();
  for (int s = 0; s < per; ++s) {
    if (s + 1 < per) issue(s + 1);  // into the stage step s-1 used
    cp_async_commit();
    cp_async_wait1();  // step s is in (this thread's copies) ...
    __syncthreads();   // ... and every thread's
    const float* As = ring + (s % STAGES) * STAGE;
    const float* Bs = As + 2 * PLANE;
    if constexpr (P != kHighest) {
      mma::FragA ar, ai;
      mma::load_a<P>(As, ROW, wr, ar);
      mma::load_a<P>(As + PLANE, ROW, wr, ai);
#pragma unroll
      for (int j = 0; j < TNR; ++j) {
        mma::FragB br, bi;
        mma::load_b<P>(Bs, ROW, 8 * j, br);
        mma::load_b<P>(Bs + PLANE, ROW, 8 * j, bi);
        float re[4], im[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) { re[e] = acc_re[e][j]; im[e] = acc_im[e][j]; }
        mma::complex_product<P, CA, CB>(re, im, ar, ai, br, bi);
#pragma unroll
        for (int e = 0; e < 4; ++e) { acc_re[e][j] = re[e]; acc_im[e][j] = im[e]; }
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        const float4 a4r = *reinterpret_cast<const float4*>(As + kk * ROW + 4 * ty);
        const float4 a4i = *reinterpret_cast<const float4*>(As + PLANE + kk * ROW + 4 * ty);
        const float ar[4] = {a4r.x, a4r.y, a4r.z, a4r.w}, ai[4] = {a4i.x, a4i.y, a4i.z, a4i.w};
        float br[TNR], bi[TNR];
        if constexpr (TNR == 4) {
          const float4 b4r = *reinterpret_cast<const float4*>(Bs + kk * ROW + 4 * tx);
          const float4 b4i = *reinterpret_cast<const float4*>(Bs + PLANE + kk * ROW + 4 * tx);
          br[0] = b4r.x; br[1] = b4r.y; br[2] = b4r.z; br[3] = b4r.w;
          bi[0] = b4i.x; bi[1] = b4i.y; bi[2] = b4i.z; bi[3] = b4i.w;
        } else {
          const float2 b2r = *reinterpret_cast<const float2*>(Bs + kk * ROW + 2 * tx);
          const float2 b2i = *reinterpret_cast<const float2*>(Bs + PLANE + kk * ROW + 2 * tx);
          br[0] = b2r.x; br[1] = b2r.y;
          bi[0] = b2i.x; bi[1] = b2i.y;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < TNR; ++j) {
            // re += ar br - (ca cb) ai bi;  im += cb ar bi + ca ai br
            acc_re[i][j] = fmaf(ar[i], br[j], acc_re[i][j]);
            acc_re[i][j] = fmaf(CA != CB ? ai[i] : -ai[i], bi[j], acc_re[i][j]);
            acc_im[i][j] = fmaf(CB ? -ar[i] : ar[i], bi[j], acc_im[i][j]);
            acc_im[i][j] = fmaf(CA ? -ai[i] : ai[i], br[j], acc_im[i][j]);
          }
      }
    }
    __syncthreads();  // every thread is done with this stage before it is refilled
  }

  // The K-split sum: each group's partial tile into the (idle) ring, then
  // the sum in group order, stored with lanes along n.
  constexpr int TT = TILE * TN;  // one plane of the tile
  float* const red = smem;       // [group][plane][m][n]
  if constexpr (P != kHighest) {
    // element e of tile j: row wr + g + 8 (e / 2), column 8 j + 2 t + e % 2
    const int g = mma::lane_g(), tq = mma::lane_t();
#pragma unroll
    for (int j = 0; j < TNR; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float* const row = red + grp * 2 * TT + (wr + g + 8 * h) * TN + 8 * j + 2 * tq;
        *reinterpret_cast<float2*>(row) = make_float2(acc_re[2 * h][j], acc_re[2 * h + 1][j]);
        *reinterpret_cast<float2*>(row + TT) =
            make_float2(acc_im[2 * h][j], acc_im[2 * h + 1][j]);
      }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float* const row = red + grp * 2 * TT + (4 * ty + i) * TN + TNR * tx;
      if constexpr (TNR == 4) {
        *reinterpret_cast<float4*>(row) =
            make_float4(acc_re[i][0], acc_re[i][1], acc_re[i][2], acc_re[i][3]);
        *reinterpret_cast<float4*>(row + TT) =
            make_float4(acc_im[i][0], acc_im[i][1], acc_im[i][2], acc_im[i][3]);
      } else {
        *reinterpret_cast<float2*>(row) = make_float2(acc_re[i][0], acc_re[i][1]);
        *reinterpret_cast<float2*>(row + TT) = make_float2(acc_im[i][0], acc_im[i][1]);
      }
    }
  }
  __syncthreads();
  if constexpr (SCATTER) {
    for (int e = threadIdx.x; e < TT; e += THREADS) {
      float vr = red[e], vi = red[TT + e];
#pragma unroll
      for (int g2 = 1; g2 < GROUPS; ++g2) {
        vr += red[g2 * 2 * TT + e];
        vi += red[g2 * 2 * TT + TT + e];
      }
      const int m = m0 + e / TN, n = n0 + e % TN;
      if (m < p.M && n < p.N) {
        const unsigned d = perm_dst(*spec, (unsigned)(m * p.N + n));
        const float s = perm_sign(*spec, d);
        p.c_re[d] = s * vr;
        p.c_im[d] = s * vi;
        if (probs) probs[d] = vr * vr + vi * vi;
      }
    }
  } else {
    for (int e = threadIdx.x; e < 2 * TT; e += THREADS) {
      float v = red[e];
#pragma unroll
      for (int g2 = 1; g2 < GROUPS; ++g2) v += red[g2 * 2 * TT + e];
      const int plane = e / TT, m = m0 + (e / TN) % TILE, n = n0 + e % TN;
      if (m < p.M && n < p.N)
        (plane ? p.c_im : p.c_re)[b * p.c_sb + (long long)m * p.c_sm + n] = v;
    }
  }
  __syncthreads();  // the ring is free for the next unit
}

// The units of one or two products, spread over the grid.
template <bool CA, bool CB, int TN = TILE, bool SCATTER = false, int P = kHighest>
__device__ void run(const Prod& p0, const Prod* p1, float* smem, const PermSpec* spec = nullptr,
                    float* probs = nullptr) {
  const int u0 = units<TN>(p0), total = u0 + (p1 ? units<TN>(*p1) : 0);
  for (int u = blockIdx.x; u < total; u += gridDim.x) {
    if (u < u0) gemm_unit<CA, CB, TN, SCATTER, P>(p0, u, smem, spec, probs);
    else gemm_unit<CA, CB, TN, SCATTER, P>(*p1, u - u0, smem, spec, probs);
  }
}

__device__ __forceinline__ bool vec_ok(const float* re, const float* im, long long s_row,
                                       long long s_k, long long s_b, int rows) {
  return s_row == 1 && rows % 4 == 0 && s_k % 4 == 0 && s_b % 4 == 0 &&
         ((unsigned long long)re & 15ull) == 0 && ((unsigned long long)im & 15ull) == 0;
}

__device__ __forceinline__ void set_vec(Prod& p) {
  p.vec_a = vec_ok(p.a_re, p.a_im, p.a_sm, p.a_sk, p.a_sb, p.M);
  p.vec_b = vec_ok(p.b_re, p.b_im, p.b_sn, p.b_sk, p.b_sb, p.N);
}

// Layer l's index map and CZ signs into the block's shared `spec`, from the
// (2 layers, n) device table: row 2l holds the layer's row masks, row 2l + 1
// its CZ masks.
__device__ __forceinline__ void load_spec(PermSpec& spec, const unsigned* masks, int n, int l) {
  if (threadIdx.x < n) {
    const unsigned* m = masks + 2LL * l * n;
    spec.rows[threadIdx.x] = m[threadIdx.x];
    spec.cz[threadIdx.x] = m[n + threadIdx.x];
  }
  if (threadIdx.x == 0) spec.nbits = n;
  __syncthreads();
}

// The device, queried once per kernel and device (per_device.cuh): its SM
// count, or the error that rules the launch out -- no cooperative launch, or
// no room for one block of the kernel on every SM at once.
struct LaunchPlan {
  cudaError_t err;
  int sms;
};

template <class Args>
inline LaunchPlan launch_plan(void (*kernel)(Args)) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
  int dev = 0, sms = 0, coop = 0, occ = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess && !coop) err = cudaErrorNotSupported;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, THREADS, SMEM);
  if (err == cudaSuccess && occ < 1) err = cudaErrorCooperativeLaunchTooLarge;
  return {err, sms};
}

// One cooperative launch of one block per SM, or the error that refused it
// (nothing launched).
template <class Args>
inline cudaError_t launch_persistent(void (*kernel)(Args), PerDevice<LaunchPlan>& plans,
                                     const Args& a, cudaStream_t st) {
  const LaunchPlan* plan = plans.get([kernel] { return launch_plan(kernel); });
  if (!plan) return cudaErrorInvalidDevice;
  if (plan->err != cudaSuccess) return plan->err;
  Args copy = a;
  void* params[] = {&copy};
  return cudaLaunchCooperativeKernel((const void*)kernel, dim3(plan->sms), dim3(THREADS), params,
                                     SMEM, st);
}

}  // namespace unit
}  // namespace tn
