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
// whole sweep: one block of 256 threads on every SM (every block resident,
// which the cooperative launch checks; one block per SM even where the
// occupancy calculator would allow more, because a phase holds about one
// unit of work per SM and further blocks would only wait at the barriers
// while leaving the spread of units over SMs to the block scheduler), the
// phases separated by grid-wide barriers (cooperative_groups grid sync), and
// every buffer the sweep touches -- four (4, R, C) buffers of 1 MB, 2 MB of
// operators, 2 MB of gradients at n=16 -- stays in the 50 MB L2.
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
// Work units: a unit is one 32x32 output tile of one product (batch element
// included), computed by the whole block: four groups of 64 threads each
// take a quarter of K (whole 16-deep steps) for the same tile, with a 4x4
// complex register tile per thread -- 64 FMAs per four float4 shared reads,
// 4 FMAs per loaded float -- and the four partial tiles are summed in shared
// memory in a fixed order (deterministic; no float atomics). At n=16 every
// phase has 128 units of 256^2 x 64 complex MACs (phi1: 64 + 64, phi2 and
// phi3: 2 x 64, the last phase 64 + 64): one unit on each of 128 SMs. Each
// group streams its K-range from L2 through a two-stage cp.async ring: 16
// bytes a copy where the operand's contiguous dimension is the tile's m (or
// n), else 4 bytes a copy (a 4-byte copy can transpose; k-contiguous
// operands need it); out-of-range elements are zero-filled by the copy, so
// ragged tiles (n=3: R=4, C=2) and odd n (R = 2C) take the same code.
//
// Flat state indices are 32-bit, as in circuit_layers.cuh.

#pragma once

#include <cooperative_groups.h>

#include "tn_gemm.cuh"

namespace tn {
namespace bwd {

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

__device__ __forceinline__ int tiles(int x) { return (x + TILE - 1) / TILE; }
__device__ __forceinline__ int units(const Prod& p) { return p.batch * tiles(p.M) * tiles(p.N); }

struct Args {
  const float* mr_re; const float* mr_im; const float* mc_re; const float* mc_im;
  const float* xr; const float* xi; const float* g;
  float* dmr_re; float* dmr_im; float* dmc_re; float* dmc_im;
  float* scratch;          // 4 x (4, R, C): U[0], U[1], V, W
  const unsigned* masks;   // (1 + layers, n): the row masks, then each layer's CZ masks
  int n, layers;
};

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

// A group's copy of one operand tile: TILE rows (m or n) x BK k per plane,
// stored k-major, tile[k * ROW + row]. re / im: the planes at (row 0, k 0)
// of the tile; rows / ks: how many rows and k are in range. Out-of-range
// elements are zero-filled (their source clamped to the base). Each thread
// copies a fixed pattern -- one start and one stride per operand -- so that
// few addresses stay live across the K loop. The operand is either
// k-contiguous (s_k == 1) or row-contiguous (s_row == 1).
__device__ __forceinline__ void load_tile(const float* re, const float* im, long long s_row,
                                          long long s_k, int rows, int ks, bool vec,
                                          float* tile, int q) {
  if (vec) {  // 16 bytes a copy: four rows at k and at k + 8, both planes
    const int row = 4 * (q % 8), kk = q / 8;
    const long long off = row + (long long)kk * s_k;
    float* const t = tile + kk * ROW + row;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const bool ok = row < rows && kk + 8 * i < ks;
      const long long o = ok ? off + 8LL * i * s_k : 0;
      cp_async16(t + 8 * i * ROW, re + o, ok);
      cp_async16(t + PLANE + 8 * i * ROW, im + o, ok);
    }
  } else if (s_k == 1) {  // k-contiguous: lanes along k, rows row + 4i
    const int kk = q % BK, row = q / BK;
    const long long off = (long long)row * s_row + kk;
    float* const t = tile + kk * ROW + row;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const bool ok = kk < ks && row + 4 * i < rows;
      const long long o = ok ? off + 4LL * i * s_row : 0;
      cp_async4(t + 4 * i, re + o, ok);
      cp_async4(t + PLANE + 4 * i, im + o, ok);
    }
  } else {  // row-contiguous, ragged: lanes along the rows, k = kk + 2i
    const int row = q % TILE, kk = q / TILE;
    const long long off = row + (long long)kk * s_k;
    float* const t = tile + kk * ROW + row;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const bool ok = row < rows && kk + 2 * i < ks;
      const long long o = ok ? off + 2LL * i * s_k : 0;
      cp_async4(t + 2 * i * ROW, re + o, ok);
      cp_async4(t + PLANE + 2 * i * ROW, im + o, ok);
    }
  }
}

// Unit t of product p, by the whole block. CA / CB: conjugate A / B.
template <bool CA, bool CB>
__device__ void gemm_unit(const Prod& p, int t, float* smem) {
  const int tn_ = tiles(p.N), tm = tiles(p.M);
  const int b = t / (tm * tn_), tile = t % (tm * tn_);
  const int m0 = (tile / tn_) * TILE, n0 = (tile % tn_) * TILE;
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
    load_tile(p.a_re + ao, p.a_im + ao, p.a_sm, p.a_sk, p.M - m0, ks, p.vec_a, st, q);
    load_tile(p.b_re + bo, p.b_im + bo, p.b_sn, p.b_sk, p.N - n0, ks, p.vec_b, st + 2 * PLANE, q);
  };

  float acc_re[4][4], acc_im[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) { acc_re[i][j] = 0.f; acc_im[i][j] = 0.f; }

  issue(0);
  cp_async_commit();
  for (int s = 0; s < per; ++s) {
    if (s + 1 < per) issue(s + 1);  // into the stage step s-1 used
    cp_async_commit();
    cp_async_wait1();  // step s is in (this thread's copies) ...
    __syncthreads();   // ... and every thread's
    const float* As = ring + (s % STAGES) * STAGE;
    const float* Bs = As + 2 * PLANE;
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a4r = *reinterpret_cast<const float4*>(As + kk * ROW + 4 * ty);
      const float4 a4i = *reinterpret_cast<const float4*>(As + PLANE + kk * ROW + 4 * ty);
      const float4 b4r = *reinterpret_cast<const float4*>(Bs + kk * ROW + 4 * tx);
      const float4 b4i = *reinterpret_cast<const float4*>(Bs + PLANE + kk * ROW + 4 * tx);
      const float ar[4] = {a4r.x, a4r.y, a4r.z, a4r.w}, ai[4] = {a4i.x, a4i.y, a4i.z, a4i.w};
      const float br[4] = {b4r.x, b4r.y, b4r.z, b4r.w}, bi[4] = {b4i.x, b4i.y, b4i.z, b4i.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          // re += ar br - (ca cb) ai bi;  im += cb ar bi + ca ai br
          acc_re[i][j] = fmaf(ar[i], br[j], acc_re[i][j]);
          acc_re[i][j] = fmaf(CA != CB ? ai[i] : -ai[i], bi[j], acc_re[i][j]);
          acc_im[i][j] = fmaf(CB ? -ar[i] : ar[i], bi[j], acc_im[i][j]);
          acc_im[i][j] = fmaf(CA ? -ai[i] : ai[i], br[j], acc_im[i][j]);
        }
    }
    __syncthreads();  // every thread is done with this stage before it is refilled
  }

  // The K-split sum: each group's partial tile into the (idle) ring, then
  // the sum in group order, stored with lanes along n.
  float* const red = smem;  // [group][plane][m][n], TILE x TILE a plane
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float* const row = red + grp * 2 * TILE * TILE + (4 * ty + i) * TILE + 4 * tx;
    *reinterpret_cast<float4*>(row) =
        make_float4(acc_re[i][0], acc_re[i][1], acc_re[i][2], acc_re[i][3]);
    *reinterpret_cast<float4*>(row + TILE * TILE) =
        make_float4(acc_im[i][0], acc_im[i][1], acc_im[i][2], acc_im[i][3]);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < 2 * TILE * TILE; e += THREADS) {
    float v = red[e];
#pragma unroll
    for (int g2 = 1; g2 < GROUPS; ++g2) v += red[g2 * 2 * TILE * TILE + e];
    const int plane = e / (TILE * TILE), m = m0 + (e / TILE) % TILE, n = n0 + e % TILE;
    if (m < p.M && n < p.N)
      (plane ? p.c_im : p.c_re)[b * p.c_sb + (long long)m * p.c_sm + n] = v;
  }
  __syncthreads();  // the ring is free for the next unit
}

// The units of one or two products, spread over the grid.
template <bool CA, bool CB>
__device__ void run(const Prod& p0, const Prod* p1, float* smem) {
  const int u0 = units(p0), total = u0 + (p1 ? units(*p1) : 0);
  for (int u = blockIdx.x; u < total; u += gridDim.x) {
    if (u < u0) gemm_unit<CA, CB>(p0, u, smem);
    else gemm_unit<CA, CB>(*p1, u - u0, smem);
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
    if (threadIdx.x < n) {
      spec.rows[threadIdx.x] = a.masks[threadIdx.x];
      spec.cz[threadIdx.x] = a.masks[(long long)(1 + l) * n + threadIdx.x];
    }
    if (threadIdx.x == 0) spec.nbits = n;
    __syncthreads();
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

// The device, queried once (the first call's): its SM count, or the error
// that rules the launch out -- no cooperative launch, or no room for one
// block of this kernel on every SM at once.
struct LaunchPlan {
  cudaError_t err;
  int sms;
};

inline LaunchPlan launch_plan() {
  cudaError_t err = cudaFuncSetAttribute(circuit2d_bwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
  int dev = 0, sms = 0, coop = 0, occ = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess && !coop) err = cudaErrorNotSupported;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, circuit2d_bwd_kernel, THREADS, SMEM);
  if (err == cudaSuccess && occ < 1) err = cudaErrorCooperativeLaunchTooLarge;
  return {err, sms};
}

// One cooperative launch of one block per SM, or the error that refused it
// (nothing launched).
inline cudaError_t circuit_backward_persistent(const Args& a, cudaStream_t st) {
  static const LaunchPlan plan = launch_plan();
  if (plan.err != cudaSuccess) return plan.err;
  const int sms = plan.sms;
  Args copy = a;
  void* params[] = {&copy};
  return cudaLaunchCooperativeKernel((const void*)circuit2d_bwd_kernel, dim3(sms),
                                     dim3(THREADS), params, SMEM, st);
}

}  // namespace bwd
}  // namespace tn
