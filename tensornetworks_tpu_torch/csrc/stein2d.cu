// Kronecker apply of the Hamming base kernel to the 3n+1 Stein columns, FP32,
// for sm_90a.
//
// Replaces the TPU kernels of tensornetworks_tpu/ops/pallas/stein2d.py:
//   make_pallas_stein2d_matvec      -> kernel   (tn_stein2d_apply)
//   make_pallas_stein2d_matvec_grid -> kernel   (tn_stein2d_apply_grid)
//
// Both compute, for every column block i, Y_i = Ar V_i Ac^T with
// Ar = A^{(x)rb}, Ac = A^{(x)cb}, A = [[1, a], [a, 1]], each V_i an (R, C)
// matrix. In MSB-first order the high rb bits of the flat index are the row
// and the low cb bits the column, so this is y_i = A^{(x)n} v_i on the flat
// 2^n column. The V build and the closed-form recombination stay outside, in
// plain torch, as they do around the TPU kernels.
//
// tn_stein2d_apply (n <= 17) keeps the dense form of the TPU kernel: two
// launches of the batched real FP32 GEMM of tn_gemm.cuh (T = Ar V_i, then
// Y_i = T_i Ac^T through a transposed stride), all blocks in one batch. At
// n=16 (R=C=256, 49 blocks) the dense products are 3.29 GFLOP, 49 us at
// 67 TFLOP/s, while the function's least work is V read once and Y written
// once, 25.7 MB, 7.7 us at 3.35 TB/s: the dense design sits far above its
// bound, and the butterfly below is queued for it too.
//
// tn_stein2d_apply_grid (n >= 18) is a Kronecker butterfly. A^{(x)n} is n
// commuting stages, one per bit k of the flat index j:
//     y[j] = x[j] + a * x[j ^ (1 << k)],
// one FMA per element and stage: 20 FMAs per element at n=20, against the
// 2 (R + C) = 4096 FLOPs per element of the dense split the TPU chose because
// its matrix unit rewards dense dots. The least work at n=20 (61 blocks) is
// then bytes: V read once and Y written once, 512 MB, 0.153 ms at 3.35 TB/s
// (the FMAs, 2.6 GFLOP, take 38 us at 67 TFLOP/s); the dense split's FLOP
// bound was 3.91 ms.
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
// Stages in a tile run in rounds of up to three bits: a thread takes the 2, 4
// or 8 elements that differ only in the round's bits into registers, applies
// the round's stages there and writes them back, one shared-memory read and
// write per element and round. Pass 1 applies bits 0 and 1 on the float4 it
// loads from device memory, so its shared rounds are {2,3,4}, {5,6,7},
// {8,9,10}, {11,12}; pass 2 at n=20 has {6,7,8}, {9,10,11}, {12}.
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
// FP32 throughout. Accuracy: each output is 20 FMA stages deep at n=20, each
// rounding once, so its error is about 20 * 2^-24 of the magnitudes it sums.

#include "tn_gemm.cuh"

namespace {

constexpr int kTileBits = 13;
constexpr int kTile = 1 << kTileBits;
constexpr int kThreads = 256;

__device__ __forceinline__ int swz(int j) { return j ^ (((j >> 5) & 7) << 2); }

// The stages of local bits k .. k+RB-1 of the tile, in registers.
template <int RB>
__device__ __forceinline__ void butterfly_round(float* tile, int k, float a) {
  constexpr int E = 1 << RB;
  const int lo_mask = (1 << k) - 1;
  for (int g = threadIdx.x; g < (kTile >> RB); g += kThreads) {
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
    if (rb == 3) butterfly_round<3>(tile, k, a);
    else if (rb == 2) butterfly_round<2>(tile, k, a);
    else butterfly_round<1>(tile, k, a);
    __syncthreads();
  }
  for (int u = threadIdx.x; u < kTile / 4; u += kThreads) {
    const int t = 4 * u;
    const long long off = base + (long long)(t >> lw) * stride + (t & wmask);
    *reinterpret_cast<float4*>(dst + off) = *reinterpret_cast<const float4*>(tile + swz(t));
  }
}

// Y_i = Ar V_i Ac^T for `cols` consecutive blocks; tmp holds `cols` blocks.
cudaError_t apply_blocks(const float* ar, const float* ac, const float* v, float* y, float* tmp,
                         int R, int C, int cols, cudaStream_t st) {
  const tn::PermSpec none = {};
  const long long S = (long long)R * C;
  tn::GemmArgs left = tn::gemm_args();
  left.a_re = ar; left.a_sm = R; left.a_sk = 1;
  left.b_re = v; left.b_sb = S; left.b_sk = C; left.b_sn = 1;
  left.c_re = tmp; left.c_sb = S; left.c_sm = C; left.c_sn = 1;
  left.M = R; left.N = C; left.K = R; left.batch = cols;
  cudaError_t err = tn::launch_gemm<false>(left, none, st);
  if (err != cudaSuccess) return err;
  tn::GemmArgs right = tn::gemm_args();
  right.a_re = tmp; right.a_sb = S; right.a_sm = C; right.a_sk = 1;
  right.b_re = ac; right.b_sk = 1; right.b_sn = C;
  right.c_re = y; right.c_sb = S; right.c_sm = C; right.c_sn = 1;
  right.M = R; right.N = C; right.K = C; right.batch = cols;
  return tn::launch_gemm<false>(right, none, st);
}

}  // namespace

extern "C" {

// ar: (R, R); ac: (C, C); v, y, tmp: (cols, R, C).
int tn_stein2d_apply(const float* ar, const float* ac, const float* v, float* y, float* tmp,
                     int R, int C, int cols, void* stream) {
  return apply_blocks(ar, ac, v, y, tmp, R, C, cols, static_cast<cudaStream_t>(stream));
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
