// Kronecker apply of the Hamming base kernel to the 3n+1 Stein columns, FP32,
// for sm_90a.
//
// Replaces the TPU kernels of tensornetworks_tpu/ops/pallas/stein2d.py:
//   make_pallas_stein2d_matvec      -> kernel, stein2d.py:45   (tn_stein2d_apply)
//   make_pallas_stein2d_matvec_grid -> kernel, stein2d.py:121  (tn_stein2d_apply_grid)
//
// Both compute, for every column block i, Y_i = Ar V_i Ac^T with
// Ar = A^{(x)rb}, Ac = A^{(x)cb}, A = [[1, a], [a, 1]], each V_i an (R, C)
// matrix. In MSB-first order the high rb bits of the flat index are the row
// and the low cb bits the column, so this is y_i = A^{(x)n} v_i on the flat
// 2^n column. The V build and the closed-form recombination stay outside, in
// plain torch, as they do around the TPU kernels.
//
// Both are Kronecker butterflies. A^{(x)n} is n commuting stages, one per
// bit k of the flat index j:
//     y[j] = x[j] + a * x[j ^ (1 << k)],
// one FMA per element and stage, against the 2 (R + C) FLOPs per element of
// the dense split the TPU chose because its matrix unit rewards dense dots.
// The least work is then bytes: V read once and Y written once.
//
// tn_stein2d_apply (n <= 17) is one launch, one pass through device memory.
// At n=16 (R=C=256, 49 blocks) that is 25.7 MB, 7.7 us at 3.35 TB/s (the
// FMAs, 51 MFLOP, take under 1 us), where the TPU kernel's dense form costs
// 3.29 GFLOP (49 us at 67 TFLOP/s). A column of 2^17 floats is 512 KB, more
// than one SM's shared memory but not more than a thread block cluster's, so
// the whole column stays on chip:
//   - a thread block holds a tile of 2^14 floats (64 KB of dynamic shared
//     memory, 256 threads, at most three blocks per SM) and applies the
//     stages of local bits 0..min(n, 14)-1 as the grid kernel's passes do
//     (bits 0, 1 on the float4 it loads, then shared rounds of up to three
//     bits, the same swizzle);
//   - n <= 14: a tile holds 2^(14-n) whole columns (the last tile may be
//     short; its missing elements are zeros that no stage mixes into a
//     column) and is stored as it is;
//   - 15 <= n <= 17: a cluster of 2^h blocks, h = n - 14 (2, 4 or 8, the
//     portable limit), holds one column, block rank r the contiguous tile
//     r. After a cluster barrier, rank r takes slice r of the local index
//     range (2^(14-h) indices), reads it from every tile of the cluster
//     through distributed shared memory (float4 reads), applies the h high
//     stages in registers and stores all 2^h outputs of each index straight
//     to Y (float4, coalesced along the slice). A second cluster barrier
//     keeps each tile alive until its partners have read it.
//   - in both passes through memory a thread starts all its 16 float4 reads
//     before it uses any: with one read in flight per thread, 196 blocks
//     hold 0.8 MB in flight, a quarter of what 3.35 TB/s needs at about a
//     microsecond of latency.
// At n=16 that is 49 clusters of 4 blocks, 196 blocks, one wave; n=17 has 52
// clusters of 8. No scratch. The launch sets the cluster size by
// cudaLaunchKernelEx, since it depends on n; before the first launch of a
// cluster size the wrapper's entry point asks whether the card can place
// one such cluster (cudaOccupancyMaxActiveClusters) and returns the error
// if not: there is no other path.
//
// tn_stein2d_apply_grid (n >= 18): 20 FMAs per element at n=20, against
// the dense split's 4096 FLOPs. The least work at n=20 (61 blocks) is V read
// once and Y written once, 512 MB, 0.153 ms at 3.35 TB/s (the FMAs, 2.6
// GFLOP, take 38 us at 67 TFLOP/s); the dense split's FLOP bound was 3.91 ms.
//
// Design: two passes over each chunk of column blocks, each pass one launch
// in which a thread block owns a tile of 2^13 floats (32 KB of dynamic shared
// memory, 256 threads) of one column block:
//   pass 1: a contiguous tile; the stages of local bits 0..12 (= global bits
//           0..12).
//   pass 2: the 2^(n-13) values of the high bits for a run of 2^lw contiguous
//           low indices, lw = 13 - (n - 13); the stages of local bits lw..12
//           (= global bits 13..n-1). Pass 2 runs in place on Y: each block
//           reads its whole tile before it writes it, and tiles are disjoint.
// Local index t of a tile lies at  base + (t >> lw) * stride + (t & (2^lw-1))
// (pass 1: lw = 13). Loads and stores are float4 (16 bytes), coalesced along
// the contiguous run: 512 bytes per warp in pass 1, runs of 2^lw floats
// (256 bytes at n=20) in pass 2; so 13 < n <= 24. Each launch has
// 2^(n-13) blocks per column block, 768 per chunk at n=20: about six per SM.
// Between the passes the chunk stays in L2 as the dense design's intermediate
// did: the caller sizes chunks to 24 MB of the 50 MB L2 (grid_chunk), and no
// scratch is needed.
//
// Stages in a tile (both kernels) run in rounds of up to three bits: a
// thread takes the 2, 4 or 8 elements that differ only in the round's bits
// into registers, applies the round's stages there and writes them back, one
// shared-memory read and write per element and round. Pass 1 applies bits 0
// and 1 on the float4 it loads from device memory, so its shared rounds are
// {2,3,4}, {5,6,7}, {8,9,10}, {11,12}; pass 2 at n=20 has {6,7,8},
// {9,10,11}, {12}; the cluster kernel's tile has {2,3,4} .. {11,12,13}. Its
// cross-tile stages read float4 at swz(t) for t = 0 mod 4: a quarter warp
// covers bits 2..4 = 0..7 at fixed bits 5..7, 128 distinct bytes.
//
// Bank-conflict plan: shared word j of a tile holds element swz(j) =
// j ^ (((j >> 5) & 7) << 2), i.e. bits 2..4 XOR bits 5..7. The 32 lanes of a
// warp take consecutive groups g. In a round at bit k >= 5 the lanes differ
// in element bits 0..4 and agree in bits 5..7, so every access hits 32 banks.
// In the round {2,3,4} lane l holds bits 0..1 = l & 3 and bits 5..7 = l >> 2
// while bits 2..4 are the element number e; the swizzle turns bits 2..4 into
// e ^ (l >> 2), so again 32 banks. (Without it, this round would be 8-way
// conflicted, and any stage at k >= 5 with pairs read as (j, j + 2^k) by one
// thread would hit one bank per warp.) The float4 load and store of a quarter
// warp cover bits 2..4 = 0..7 at fixed bits 5..7: 128 distinct bytes. For
// n >= 22 pass 2 has rounds below bit 5 (lw < 5) that are not covered by this
// plan; they are correct and may conflict.
//
// FP32 throughout. Accuracy: each output is n FMA stages deep, each rounding
// once, so its error is about n * 2^-24 of the magnitudes it sums.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "per_device.cuh"

namespace {

constexpr int kTileBits = 13;
constexpr int kTile = 1 << kTileBits;
constexpr int kThreads = 256;

__device__ __forceinline__ int swz(int j) { return j ^ (((j >> 5) & 7) << 2); }

// The stages of local bits k .. k+RB-1 of a tile of 2^TB floats, in
// registers.
template <int TB, int RB>
__device__ __forceinline__ void butterfly_round(float* tile, int k, float a) {
  constexpr int E = 1 << RB;
  const int lo_mask = (1 << k) - 1;
  for (int g = threadIdx.x; g < ((1 << TB) >> RB); g += kThreads) {
    const int j0 = ((g & ~lo_mask) << RB) | (g & lo_mask);
    float x[E];
#pragma unroll
    for (int e = 0; e < E; ++e) x[e] = tile[swz(j0 + (e << k))];
#pragma unroll
    for (int s = 0; s < RB; ++s)
#pragma unroll
      for (int e = 0; e < E; ++e)
        if (!(e & (1 << s))) {
          const float x0 = x[e], x1 = x[e | (1 << s)];
          x[e] = fmaf(a, x1, x0);
          x[e | (1 << s)] = fmaf(a, x0, x1);
        }
#pragma unroll
    for (int e = 0; e < E; ++e) tile[swz(j0 + (e << k))] = x[e];
  }
}

__device__ __forceinline__ void pair_stage(float& x0, float& x1, float a) {
  const float y0 = fmaf(a, x1, x0);
  x1 = fmaf(a, x0, x1);
  x0 = y0;
}

// One pass over the tiles of `cols` column blocks of 2^n floats: block
// (sub, col) owns local indices t -> col 2^n + sub 2^lw + (t >> lw) stride
// + (t & (2^lw - 1)) and applies the stages of local bits k_lo .. 12.
__global__ void __launch_bounds__(kThreads)
butterfly_pass_kernel(const float* src, float* dst, float a, int n, int lw, long long stride,
                      int k_lo) {
  extern __shared__ __align__(16) float tile[];
  const long long base = ((long long)blockIdx.y << n) + ((long long)blockIdx.x << lw);
  const int wmask = (1 << lw) - 1;
  for (int u = threadIdx.x; u < kTile / 4; u += kThreads) {
    const int t = 4 * u;
    const long long off = base + (long long)(t >> lw) * stride + (t & wmask);
    float4 v = *reinterpret_cast<const float4*>(src + off);
    if (k_lo == 0) {  // local bits 0 and 1 are stage bits: apply them here
      pair_stage(v.x, v.y, a);
      pair_stage(v.z, v.w, a);
      pair_stage(v.x, v.z, a);
      pair_stage(v.y, v.w, a);
    }
    *reinterpret_cast<float4*>(tile + swz(t)) = v;
  }
  __syncthreads();
  for (int k = k_lo == 0 ? 2 : k_lo; k < kTileBits; k += 3) {
    const int rb = kTileBits - k < 3 ? kTileBits - k : 3;
    if (rb == 3) butterfly_round<kTileBits, 3>(tile, k, a);
    else if (rb == 2) butterfly_round<kTileBits, 2>(tile, k, a);
    else butterfly_round<kTileBits, 1>(tile, k, a);
    __syncthreads();
  }
  for (int u = threadIdx.x; u < kTile / 4; u += kThreads) {
    const int t = 4 * u;
    const long long off = base + (long long)(t >> lw) * stride + (t & wmask);
    *reinterpret_cast<float4*>(dst + off) = *reinterpret_cast<const float4*>(tile + swz(t));
  }
}

constexpr int kClusterTileBits = 14;
constexpr int kClusterTile = 1 << kClusterTileBits;
constexpr int kMaxClusterBits = 3;  // clusters of up to 8 blocks, the portable limit
constexpr int kPerThread = kClusterTile / 4 / kThreads;  // float4 a thread moves in a pass: 16

// The h = n - 14 cross-tile stages of the cluster's column: this block's
// slice of the local index range, read from every tile of the cluster. A
// thread reads all its 16 float4 (P tiles x ITER indices) before it uses
// any, so that their latencies overlap.
template <int H>
__device__ __forceinline__ void cluster_stages(float* tile, float* y, float a) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  constexpr int P = 1 << H, SLICE = kClusterTile >> H, ITER = SLICE / 4 / kThreads;
  const int rank = (int)cluster.block_rank();
  const float* src[P];
#pragma unroll
  for (int q = 0; q < P; ++q) src[q] = cluster.map_shared_rank(tile, q);
  // tile q of the column starts at col + (q << 14)
  float* const col = y + ((long long)(blockIdx.x >> H) << (kClusterTileBits + H));
  float4 x[ITER][P];
#pragma unroll
  for (int it = 0; it < ITER; ++it) {
    const int t = rank * SLICE + 4 * (threadIdx.x + it * kThreads);
#pragma unroll
    for (int q = 0; q < P; ++q) x[it][q] = *reinterpret_cast<const float4*>(src[q] + swz(t));
  }
#pragma unroll
  for (int it = 0; it < ITER; ++it)
#pragma unroll
    for (int s = 0; s < H; ++s)
#pragma unroll
      for (int q = 0; q < P; ++q)
        if (!(q & (1 << s))) {
          float4& x0 = x[it][q];
          float4& x1 = x[it][q | (1 << s)];
          pair_stage(x0.x, x1.x, a);
          pair_stage(x0.y, x1.y, a);
          pair_stage(x0.z, x1.z, a);
          pair_stage(x0.w, x1.w, a);
        }
#pragma unroll
  for (int it = 0; it < ITER; ++it) {
    const int t = rank * SLICE + 4 * (threadIdx.x + it * kThreads);
#pragma unroll
    for (int q = 0; q < P; ++q)
      *reinterpret_cast<float4*>(col + ((long long)q << kClusterTileBits) + t) = x[it][q];
  }
}

// Local bits 0 and 1 of a float4 (elements 4u .. 4u+3), as far as they are
// stage bits (local = the tile's stage bits).
__device__ __forceinline__ void low_stages(float4& x, int local, float a) {
  if (local >= 1) {
    pair_stage(x.x, x.y, a);
    pair_stage(x.z, x.w, a);
  }
  if (local >= 2) {
    pair_stage(x.x, x.z, a);
    pair_stage(x.y, x.w, a);
  }
}

// One launch over all columns of 2^n floats (total = cols 2^n): block b owns
// the contiguous tile b of 2^14 floats. n <= 14: the block's tile holds
// whole columns and is stored by the block. n > 14: the blocks of a cluster
// (2^(n-14) of them, one column) finish the high stages together.
__global__ void __launch_bounds__(kThreads)
cluster_butterfly_kernel(const float* __restrict__ v, float* __restrict__ y, float a, int n,
                         long long total) {
  extern __shared__ __align__(16) float tile[];
  const int local = n < kClusterTileBits ? n : kClusterTileBits;
  const long long base = (long long)blockIdx.x << kClusterTileBits;
  if (base + kClusterTile <= total) {  // a whole tile: all 16 loads in flight at once
    float4 x[kPerThread];
#pragma unroll
    for (int i = 0; i < kPerThread; ++i)
      x[i] = *reinterpret_cast<const float4*>(v + base + 4 * (threadIdx.x + i * kThreads));
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      low_stages(x[i], local, a);
      *reinterpret_cast<float4*>(tile + swz(4 * (threadIdx.x + i * kThreads))) = x[i];
    }
  } else {  // the short last tile (n <= 14): zeros past the end
    for (int u = threadIdx.x; u < kClusterTile / 4; u += kThreads) {
      const long long off = base + 4 * u;
      float4 x;
      x.x = off < total ? v[off] : 0.f;
      x.y = off + 1 < total ? v[off + 1] : 0.f;
      x.z = off + 2 < total ? v[off + 2] : 0.f;
      x.w = off + 3 < total ? v[off + 3] : 0.f;
      low_stages(x, local, a);
      *reinterpret_cast<float4*>(tile + swz(4 * u)) = x;
    }
  }
  __syncthreads();
  for (int k = 2; k < local; k += 3) {
    const int rb = local - k < 3 ? local - k : 3;
    if (rb == 3) butterfly_round<kClusterTileBits, 3>(tile, k, a);
    else if (rb == 2) butterfly_round<kClusterTileBits, 2>(tile, k, a);
    else butterfly_round<kClusterTileBits, 1>(tile, k, a);
    __syncthreads();
  }
  const int h = n - local;
  if (h == 0) {
    for (int u = threadIdx.x; u < kClusterTile / 4; u += kThreads) {
      const long long off = base + 4 * u;
      const float4 x = *reinterpret_cast<const float4*>(tile + swz(4 * u));
      if (off + 4 <= total) {
        *reinterpret_cast<float4*>(y + off) = x;
      } else {
        if (off < total) y[off] = x.x;
        if (off + 1 < total) y[off + 1] = x.y;
        if (off + 2 < total) y[off + 2] = x.z;
      }
    }
    return;
  }
  namespace cg = cooperative_groups;
  cg::this_cluster().sync();  // every tile of the column has its low stages
  if (h == 1) cluster_stages<1>(tile, y, a);
  else if (h == 2) cluster_stages<2>(tile, y, a);
  else cluster_stages<3>(tile, y, a);
  cg::this_cluster().sync();  // no tile leaves before its partners have read it
}

// Whether the current card can place one cluster of 2^h blocks of the
// cluster kernel, asked once per card and h; cudaSuccess or the error that
// rules it out.
cudaError_t cluster_plan(int h, const cudaLaunchConfig_t& cfg) {
  static tn::PerDevice<cudaError_t> answers[kMaxClusterBits + 1];
  const cudaError_t* answer = answers[h].get([&] {
    cudaError_t err = cudaFuncSetAttribute(cluster_butterfly_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)cfg.dynamicSmemBytes);
    int clusters = 0;
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveClusters(&clusters, cluster_butterfly_kernel, &cfg);
    if (err == cudaSuccess && clusters < 1) err = cudaErrorLaunchOutOfResources;
    return err;
  });
  return answer ? *answer : cudaErrorInvalidDevice;
}

}  // namespace

extern "C" {

// v, y: (cols, 2^n) float32, 16-byte aligned; a: the decay factor;
// 1 <= n <= 17. One launch; a card that cannot place the cluster returns
// its error and launches nothing.
int tn_stein2d_apply(const float* v, float* y, float a, int n, int cols, void* stream) {
  if (n < 1 || n > kClusterTileBits + kMaxClusterBits || cols < 1)
    return (int)cudaErrorInvalidValue;
  const int h = n > kClusterTileBits ? n - kClusterTileBits : 0;
  const long long total = (long long)cols << n;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((total + kClusterTile - 1) >> kClusterTileBits));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kClusterTile * sizeof(float);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1u << h;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cluster_plan(h, cfg);
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernelEx(&cfg, cluster_butterfly_kernel, v, y, a, n, total);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// v, y: (cols, 2^n) float32, 16-byte aligned; a: the decay factor;
// 13 < n <= 24; chunk: column blocks per pair of passes.
int tn_stein2d_apply_grid(const float* v, float* y, float a, int n, int cols, int chunk,
                          void* stream) {
  if (n <= kTileBits || n > 2 * kTileBits - 2 || chunk < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int high = n - kTileBits;         // bits left for pass 2
  const int lw = kTileBits - high;        // pass 2: contiguous run of 2^lw floats
  const size_t smem = kTile * sizeof(float);
  for (int c0 = 0; c0 < cols; c0 += chunk) {
    const int nb = cols - c0 < chunk ? cols - c0 : chunk;
    const long long off = (long long)c0 << n;
    const dim3 grid(1u << high, nb);
    butterfly_pass_kernel<<<grid, kThreads, smem, st>>>(v + off, y + off, a, n, kTileBits, 0, 0);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    butterfly_pass_kernel<<<grid, kThreads, smem, st>>>(y + off, y + off, a, n, lw,
                                                        1LL << kTileBits, lw);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // extern "C"
