// The Hopper main loop of the bf16 products of the grid circuit kernels 5
// and 6 (kernel precision `high` and `default`, ops/kernels/precision.py):
// TMA copies of pre-split bf16 planes into a ring of swizzled tiles, and
// wgmma.mma_async from shared memory, for every product that
// tn_gemm.cuh's large loop takes (large::pattern: M % 128 == 0, N % 64 ==
// 0, at least 128 tiles of 128 x 64; the n >= 19 pull-backs and dMr, and
// from n = 20 every product of both kernels). The products with fewer tiles
// (every product at n = 18; dMc, the forward's left and scatter products at
// n = 19) keep tn_gemm.cuh's gemm_kernel and its mma.sync passes
// (mma_bf16.cuh), which read the FP32 planes.
//
// Replaces the bf16 dots (`_dot` at DEFAULT or HIGH) inside the TPU kernels
// of tensornetworks_tpu/ops/pallas/circuit2d_grid.py (fwd_kernel,
// bwd_kernel). Bound: the dense bf16 tensor-core rate, 989 TFLOP/s; at n=24
// a complex 4096^3 product under `high` is 12 real GEMM passes, 1.65e12
// FLOP (1.67 ms).
//
// 1. The split. Each operand plane x is read as bf16 planes written once,
//    outside the main loop: hi = bf16_rn(x) and, under `high`, lo =
//    bf16_rn(x - hi) (precision.split_bf16's values), in a "shadow" buffer
//    at the FP32 element's offset (Shadow). The static operators are split
//    per layer by split_planes_kernel; every kernel that writes a state
//    plane a bf16 product reads also writes its split (the epilogues below,
//    circuit_layers.cuh's cotangent and unpermute kernels). The FP32 planes
//    are still written where anything reads them (the next index map,
//    probs, dM and the mma.sync products): all but the forward's tmp.
// 2. TMA. One thread starts cp.async.bulk.tensor copies of each stage's
//    tiles (every plane of A and B, 128 x BK and BN x BK bf16; BK below)
//    into a ring of STAGES stages, completing on an mbarrier per stage; the
//    two warpgroups release a stage on a second mbarrier, and the thread
//    then copies the tile STAGES ahead into it. A k-contiguous operand
//    ("K-major", the tile's rows are 2 BK bytes of k) is copied with a
//    swizzle as wide (64 or 128 bytes); an m- or n-contiguous one
//    ("MN-major", rows of 64 elements along m or n, one row per k) with the
//    128-byte swizzle, and wgmma reads it through its transpose bit. So no operand is transposed
//    in registers, and the forward's right product reads Mc itself as a
//    K-major B (no Mc^T scratch). The tensor maps are encoded on the host
//    for each product (the operands move per layer) through
//    cudaGetDriverEntryPoint, so the libraries need no -lcuda.
// 3. wgmma. Two warpgroups take 64 rows each of the 128 x BN tile
//    (m64nBNk16). A complex product is real products over an extended K:
//        re = ar br + (-ca cb) ai bi,   im = cb ar bi + ca ai br,
//    the sign (ca / cb = -1 for a conjugated A / B) carried by wgmma's
//    scale-a immediate (exact); under `high` each real product is the
//    passes lo.hi + hi.lo + hi.hi. A stage (two k16 steps under `high`,
//    four under `default`) thus holds 12 or 8 wgmma per part of the
//    result.
// 4. Promotion. The tensor cores accumulate FP32 by truncating aligned
//    addends, which chained over the whole of K put `high` at 3.5e-4 of
//    float64 at n=24 (mma_bf16.cuh). So each stage's products for re are
//    summed from zero in a fresh wgmma accumulator, waited for and added to
//    the FP32 register accumulator by FADD; then im's the same way (64 x BN
//    per warpgroup: BN / 2 registers a thread for each). At BN = 64 im's
//    sum has registers of its own and runs while re's is added; at BN =
//    128 the two share them (3 x 64 registers in all).
//
// Tiles: BM = 128 and BN = 128 where the product has at least two waves of
// 128 x 128 tiles on 132 SMs (264 tiles: n = 24, and n = 22's batch-2
// pull-backs), else BN = 64 (n = 20: a 1024^2 output has 128 tiles of 128
// x 64 and only 64 of 128 x 128). 128-wide tiles read half as many bytes
// per FLOP from L2. A stage's k, BK: 32 under `high`, where a stage of 128
// x 128 holds 8 planes x 8 KB = 64 KB and three stages fit in 192 KB; 64
// under `default`, whose 4 planes fill the same 64 KB, so that a stage's
// chain is 8 wgmma and not 4 between waits. Blocks walk the tiles in
// groups of 8 tile rows (`raster`), so that the B tiles a group reads stay
// in L2.
//
// Epilogues: FP32 stores (float2 a thread and row; none where c_re is
// null, as for the forward's tmp, which only its split is read from), and
// the split of C where the next product reads it; the forward's scatter
// epilogue sends element (m, n) to d = dst(m N) ^ dst(n) with the CZ sign
// per element and |C|^2 to probs on the last layer, as tn_gemm.cuh's large
// loop does.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes from the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "tn_gemm.cuh"

namespace tn {
namespace wg {

typedef __nv_bfloat16 bf16;

// ------------------------------------------------------------------ split

// The bf16 split of an FP32 buffer of `size` elements: hi at [0, size) and,
// under kHigh, lo at [size, 2 size), each at its FP32 element's offset.
struct Shadow {
  const float* base;
  long long size;
  bf16* hi;
  bf16* hi_of(const float* p) const { return hi + (p - base); }
  bf16* lo_of(const float* p) const { return hi + size + (p - base); }
};

// x's hi (and, for kHigh, lo) at element `off` of the planes hi and lo.
template <int P>
__device__ __forceinline__ void store_split(bf16* hi, bf16* lo, long long off, float x) {
  const bf16 h = __float2bfloat16_rn(x);
  hi[off] = h;
  if constexpr (P == kHigh) lo[off] = __float2bfloat16_rn(x - __bfloat162float(h));
}

// The same for (x0, x1) at off, off + 1 (off even): one 4-byte store a plane.
template <int P>
__device__ __forceinline__ void store_split2(bf16* hi, bf16* lo, long long off, float x0,
                                             float x1) {
  unsigned h, l;
  mma::split<P>(x0, x1, h, l);
  *reinterpret_cast<unsigned*>(hi + off) = h;
  if constexpr (P == kHigh) *reinterpret_cast<unsigned*>(lo + off) = l;
}

struct SplitJob {
  const float* src;
  bf16* hi;
  bf16* lo;
  long long n;
};
constexpr int kMaxJobs = 4;
struct SplitJobs {
  SplitJob job[kMaxJobs];
};

// hi (and lo) of each job's n elements; blockIdx.y picks the job.
template <int P>
__global__ void split_planes_kernel(SplitJobs jobs) {
  const SplitJob j = jobs.job[blockIdx.y];
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < j.n; i += step)
    store_split<P>(j.hi, j.lo, i, j.src[i]);
}

// The split of `count` FP32 planes, each into its shadow.
template <int P>
inline cudaError_t split_planes(const SplitJob* jobs, int count, cudaStream_t st) {
  if (count < 1 || count > kMaxJobs) return cudaErrorInvalidValue;
  SplitJobs all = {};
  long long most = 0;
  for (int i = 0; i < count; ++i) {
    all.job[i] = jobs[i];
    most = jobs[i].n > most ? jobs[i].n : most;
  }
  const long long blocks = (most + 255) / 256;
  split_planes_kernel<P><<<dim3((unsigned)(blocks < 1056 ? blocks : 1056), count), 256, 0, st>>>(
      all);
  return cudaGetLastError();
}

// The job that splits FP32 plane `src` of n elements into its shadow `s`.
inline SplitJob job(const Shadow& s, const float* src, long long n) {
  return SplitJob{src, s.hi_of(src), s.lo_of(src), n};
}

// ------------------------------------------------------------ the main loop

constexpr int BM = 128, WARPGROUPS = 2, THREADS = 128 * WARPGROUPS;
// A product the loop takes has K % K_STEP == 0 (both stage depths divide it).
constexpr int K_STEP = 64;
constexpr int RING_BYTES = 192 * 1024;

template <int P, int BN>
struct Tile {
  static constexpr int NP = P == kHigh ? 4 : 2;  // planes an operand: hi re, hi im[, lo re, lo im]
  // k of a stage: 32 under kHigh (8 planes), 64 under kDefault (4), so that
  // a stage of 128 x 128 holds 64 KB either way.
  static constexpr int BK = P == kHigh ? 32 : 64;
  static constexpr int A_BYTES = BM * BK * 2, B_BYTES = BN * BK * 2;
  // an MN-major box: BK rows of 64 elements (128 bytes); a K-major tile's
  // rows are 2 BK bytes, 64 of them as many bytes as one box
  static constexpr int BOX = BK * 128;
  static constexpr int STAGE = NP * (A_BYTES + B_BYTES);
  static constexpr int STAGES = RING_BYTES / STAGE > 8 ? 8 : RING_BYTES / STAGE;
  // 1024 bytes to align the ring (the 128-byte swizzle's period), then the
  // full and empty barriers.
  static constexpr size_t SMEM = 1024 + (size_t)STAGES * STAGE + 16 * STAGES;
};

// The tensor maps of A's and B's planes (hi re, hi im, lo re, lo im).
struct Maps {
  CUtensorMap a[4], b[4];
};

// The bf16 planes a product reads, in Maps' order.
struct Operands {
  const bf16* a[4];
  const bf16* b[4];
};

// The epilogue's split of C (hi re, hi im, lo re, lo im); null: not written.
struct Out {
  bf16* c[4];
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Until the barrier's phase of parity `parity` has completed. A wait of
// more than 2^34 cycles (about 9 s; a stage takes microseconds) traps, so a
// stalled ring ends the launch with an error instead of holding the card.
constexpr long long kStallCycles = 1LL << 34;

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  const long long start = clock64();
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (!done && clock64() - start > kStallCycles) __trap();
  } while (!done);
}

// A (inner, outer, batch) box of a tensor map into shared memory, completing
// on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                         int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Until at most N committed groups of this warpgroup are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of the accumulator across
// a wgmma fence, commit or wait.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// A shared-memory matrix descriptor: start address, leading and stride byte
// offsets, swizzle (1: 128 bytes, 2: 64 bytes).
__device__ __forceinline__ uint64_t descriptor(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                               uint64_t swizzle) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (swizzle << 62);
}

// The descriptor of k16 step kk of an operand tile of BK k. K-major: rows
// of 2 BK bytes, swizzled as wide (64 bytes for BK = 32, 128 for 64), 8-row
// groups 16 BK bytes apart, step kk 32 kk bytes in. MN-major: one 128-byte
// row of 64 m (or n) per k, 128-byte swizzle, 8-k groups 1024 bytes apart,
// 64-wide blocks of m (or n) a box (128 BK bytes) apart, step kk 16 kk rows
// (2048 kk bytes) in.
template <bool MN, int BK>
__device__ __forceinline__ uint64_t tile_desc(uint32_t addr, int kk) {
  return MN ? descriptor(addr + 2048 * kk, 128 * BK, 1024, 1)
            : descriptor(addr + 32 * kk, 16, 16 * BK, BK == 64 ? 1 : 2);
}

template <int N>
struct Width {};

template <int SA, int TA, int TB>
__device__ __forceinline__ void mma_async(float (&d)[32], uint64_t da, uint64_t db, int acc,
                                          Width<64>) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, %35, 1, %36, %37;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc), "n"(SA), "n"(TA), "n"(TB));
}

template <int SA, int TA, int TB>
__device__ __forceinline__ void mma_async(float (&d)[64], uint64_t da, uint64_t db, int acc,
                                          Width<128>) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, %67, 1, %68, %69;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(acc), "n"(SA), "n"(TA), "n"(TB));
}

// Output tile (mt, nt) of block `pid`: tile rows in groups of 8, the blocks
// of a group walking its rows first, then its columns.
__device__ __forceinline__ void raster(int pid, int tiles_m, int tiles_n, int& mt, int& nt) {
  constexpr int G = 8;
  const int width = G * tiles_n, first = pid / width * G;
  const int rows = tiles_m - first < G ? tiles_m - first : G;
  mt = first + pid % width % rows;
  nt = pid % width / rows;
}

// One part (re or im) of a stage's complex product into t, sent and
// committed as one group: both k16 steps, both terms (A plane ac against B
// plane bc, A's sign S0 / S1), each as P's passes; t is summed from zero.
template <bool AT, bool BT, int P, int BN, int AC0, int BC0, int S0, int AC1, int BC1, int S1>
__device__ __forceinline__ void stage_part(float (&t)[BN / 2], uint32_t a0, uint32_t b0) {
  using T = Tile<P, BN>;
  constexpr int TA = AT ? 1 : 0, TB = BT ? 1 : 0;
  // plane q of A / B: component c (0 re, 1 im), part h (0 hi, 1 lo): q = c + 2 h
  const auto a = [&](int c, int h, int kk) {
    return tile_desc<AT, T::BK>(a0 + (c + 2 * h) * T::A_BYTES, kk);
  };
  const auto b = [&](int c, int h, int kk) {
    return tile_desc<BT, T::BK>(b0 + (c + 2 * h) * T::B_BYTES, kk);
  };
  wgmma_fence();
  fence_regs(t);
#pragma unroll
  for (int kk = 0; kk < T::BK / 16; ++kk) {
    const int acc = kk > 0;  // the first product of the stage starts t from zero
    if constexpr (P == kHigh) {
      mma_async<S0, TA, TB>(t, a(AC0, 1, kk), b(BC0, 0, kk), acc, Width<BN>());
      mma_async<S0, TA, TB>(t, a(AC0, 0, kk), b(BC0, 1, kk), 1, Width<BN>());
      mma_async<S0, TA, TB>(t, a(AC0, 0, kk), b(BC0, 0, kk), 1, Width<BN>());
      mma_async<S1, TA, TB>(t, a(AC1, 1, kk), b(BC1, 0, kk), 1, Width<BN>());
      mma_async<S1, TA, TB>(t, a(AC1, 0, kk), b(BC1, 1, kk), 1, Width<BN>());
    } else {
      mma_async<S0, TA, TB>(t, a(AC0, 0, kk), b(BC0, 0, kk), acc, Width<BN>());
    }
    mma_async<S1, TA, TB>(t, a(AC1, 0, kk), b(BC1, 0, kk), 1, Width<BN>());
  }
  wgmma_commit();
}

// Stage s's copies of tile kt (every plane of A and B), completing on
// full[s]; started by one thread.
template <bool AT, bool BT, int P, int BN>
__device__ __forceinline__ void load_stage(uint8_t* ring, const Maps& maps, uint64_t* full,
                                           int s, int kt, int m0, int n0, int b) {
  using T = Tile<P, BN>;
  const int k0 = kt * T::BK;
  mbar_expect_tx(&full[s], T::STAGE);
  uint8_t* const st = ring + s * T::STAGE;
#pragma unroll
  for (int q = 0; q < T::NP; ++q) {
    uint8_t* const at = st + q * T::A_BYTES;
    if (AT) {
      tma_load(at, &maps.a[q], &full[s], m0, k0, b);
      tma_load(at + T::BOX, &maps.a[q], &full[s], m0 + 64, k0, b);
    } else {
      tma_load(at, &maps.a[q], &full[s], k0, m0, b);
    }
    uint8_t* const bt = st + T::NP * T::A_BYTES + q * T::B_BYTES;
    if (BT) {
#pragma unroll
      for (int c = 0; c < BN / 64; ++c)
        tma_load(bt + T::BOX * c, &maps.b[q], &full[s], n0 + 64 * c, k0, b);
    } else {
      tma_load(bt, &maps.b[q], &full[s], k0, n0, b);
    }
  }
}

// AT / BT: A / B is MN-major (m- / n-contiguous), else K-major; CA / CB:
// conjugate A / B; SCATTER: the forward's scatter epilogue (batch 1).
// Two warpgroups, 64 rows of the tile each; thread 0 also starts the
// copies: the whole ring at the start, then at each step the tile STAGES
// ahead into the stage both warpgroups have just released. No warp is
// given to copies alone: with a producer warp or warpgroup (288 or 384
// threads) ptxas allotted 168 registers a thread, setmaxnreg
// notwithstanding, and the BN = 128 instantiations (3 x BN / 2 = 192
// accumulators) spilled about 450 bytes; 256 threads leave 255.
template <bool AT, bool BT, bool CA, bool CB, bool SCATTER, int P, int BN>
__global__ void __launch_bounds__(THREADS, 1)
    cgemm_wgmma_kernel(const __grid_constant__ Maps maps, GemmArgs p, Out out, PermSpec spec) {
  using T = Tile<P, BN>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* const ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* const full = reinterpret_cast<uint64_t*>(ring + T::STAGES * T::STAGE);
  uint64_t* const empty = full + T::STAGES;
  int mt, nt;
  raster(blockIdx.x, p.M / BM, p.N / BN, mt, nt);
  const int m0 = mt * BM, n0 = nt * BN, b = blockIdx.z, nk = p.K / T::BK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bool copier = threadIdx.x == 0;

  if (copier) {
    for (int s = 0; s < T::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * WARPGROUPS);  // lane 0 of every warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (copier)
    for (int kt = 0; kt < T::STAGES && kt < nk; ++kt)
      load_stage<AT, BT, P, BN>(ring, maps, full, kt, kt, m0, n0, b);

  // Warpgroup wgi: rows 64 wgi .. 64 wgi + 63 of the tile. Register
  // d[4 j + 2 h + e] of m64nBNk16 holds row 16 w + g + 8 h, column 8 j + 2 q
  // + e (w: warp in the group, g = lane / 4, q = lane % 4).
  const int wgi = warp / 4;
  constexpr int R = BN / 2;
  // re's and im's stage sums: two accumulators where they fit (BN = 64:
  // 4 x 32 registers), so that im's products run while re's are added;
  // one, re's then im's, at BN = 128 (3 x 64).
  constexpr bool TWO = BN == 64;
  float acc_re[R], acc_im[R], t[R], t2[TWO ? R : 1];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    acc_re[i] = 0.f;
    acc_im[i] = 0.f;
    t[i] = 0.f;
    if constexpr (TWO) t2[i] = 0.f;
  }
  // re = ar br + (-ca cb) ai bi;  im = cb ar bi + ca ai br
  constexpr int SRE = CA == CB ? -1 : 1, SIB = CB ? -1 : 1, SIA = CA ? -1 : 1;
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % T::STAGES;
    // refill the stage of tile kt - 1 with tile kt - 1 + STAGES
    const int prev = kt - 1, next = kt - 1 + T::STAGES;
    if (copier && prev >= 0 && next < nk) {
      mbar_wait(&empty[prev % T::STAGES], (prev / T::STAGES) & 1);
      load_stage<AT, BT, P, BN>(ring, maps, full, prev % T::STAGES, next, m0, n0, b);
    }
    __syncwarp();  // warp 0 whole again before its wgmma
    mbar_wait(&full[s], (kt / T::STAGES) & 1);
    const uint32_t a0 = smem_u32(ring + s * T::STAGE) + T::BOX * wgi;
    const uint32_t b0 = smem_u32(ring + s * T::STAGE + T::NP * T::A_BYTES);
    if constexpr (TWO) {
      stage_part<AT, BT, P, BN, 0, 0, 1, 1, 1, SRE>(t, a0, b0);
      stage_part<AT, BT, P, BN, 0, 1, SIB, 1, 0, SIA>(t2, a0, b0);
      wgmma_wait<1>();
      fence_regs(t);
#pragma unroll
      for (int i = 0; i < R; ++i) acc_re[i] += t[i];
      wgmma_wait<0>();
      fence_regs(t2);
      if (lane == 0) mbar_arrive(&empty[s]);
#pragma unroll
      for (int i = 0; i < R; ++i) acc_im[i] += t2[i];
    } else {
      stage_part<AT, BT, P, BN, 0, 0, 1, 1, 1, SRE>(t, a0, b0);
      wgmma_wait<0>();
      fence_regs(t);
#pragma unroll
      for (int i = 0; i < R; ++i) acc_re[i] += t[i];
      stage_part<AT, BT, P, BN, 0, 1, SIB, 1, 0, SIA>(t, a0, b0);
      wgmma_wait<0>();
      fence_regs(t);
      if (lane == 0) mbar_arrive(&empty[s]);
#pragma unroll
      for (int i = 0; i < R; ++i) acc_im[i] += t[i];
    }
  }

  const int w = warp % 4, g = lane / 4, q = lane % 4;
  const int mrow = m0 + 64 * wgi + 16 * w + g;
  if constexpr (SCATTER) {
    // n = n0 + 8 j + 2 q + e: disjoint bits, so dst(n) = dst(n0 + 2 q) ^
    // dst(8 j) ^ e dst(1), and dst(m N + n) = dst(m N) ^ dst(n) (N a power
    // of two, the map GF(2)-linear).
    const unsigned dq = perm_dst(spec, (unsigned)(n0 + 2 * q)), d1 = perm_dst(spec, 1u);
    constexpr int JB = BN == 128 ? 4 : 3;  // bits of j
    unsigned dj[JB];
#pragma unroll
    for (int i = 0; i < JB; ++i) dj[i] = perm_dst(spec, 8u << i);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const unsigned dm = perm_dst(spec, (unsigned)(mrow + 8 * h) * (unsigned)p.N) ^ dq;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        unsigned dmj = dm;
#pragma unroll
        for (int i = 0; i < JB; ++i)
          if (j >> i & 1) dmj ^= dj[i];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const unsigned d = e ? dmj ^ d1 : dmj;
          const float sg = perm_sign(spec, d);
          const float vr = acc_re[4 * j + 2 * h + e], vi = acc_im[4 * j + 2 * h + e];
          if (p.c_re) {
            p.c_re[d] = sg * vr;
            p.c_im[d] = sg * vi;
          }
          if (p.probs) p.probs[d] = vr * vr + vi * vi;
          if (out.c[0]) {
            store_split<P>(out.c[0], out.c[2], d, sg * vr);
            store_split<P>(out.c[1], out.c[3], d, sg * vi);
          }
        }
      }
    }
  } else {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long row = b * p.c_sb + (long long)(mrow + 8 * h) * p.c_sm + n0 + 2 * q;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const long long off = row + 8 * j;
        const int i = 4 * j + 2 * h;
        if (p.c_re) {
          *reinterpret_cast<float2*>(p.c_re + off) = make_float2(acc_re[i], acc_re[i + 1]);
          *reinterpret_cast<float2*>(p.c_im + off) = make_float2(acc_im[i], acc_im[i + 1]);
        }
        if (out.c[0]) {
          store_split2<P>(out.c[0], out.c[2], off, acc_re[i], acc_re[i + 1]);
          store_split2<P>(out.c[1], out.c[3], off, acc_im[i], acc_im[i + 1]);
        }
      }
    }
  }
}

// ------------------------------------------------------------------- host

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, fetched by cudaGetDriverEntryPoint (null where
// the installed CUDA does not give it).
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000,
                                                           cudaEnableDefault, &q);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &q);
#endif
    return e == cudaSuccess && q == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(f)
                                                               : nullptr;
  }();
  return fn;
}

// One bf16 plane as a (inner, outer, batch) tensor, element strides s_outer
// and s_batch, in boxes of (box_inner, box_outer, 1). A single batch gets
// the plane's own extent as its stride (the map wants one, and a product's
// batch stride is 0 then).
inline bool encode(CUtensorMap* map, const bf16* base, long long inner, long long outer,
                   long long s_outer, long long batch, long long s_batch, int box_inner,
                   int box_outer, bool swizzle128) {
  const EncodeTiled fn = encode_tiled();
  if (!fn || !base) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)inner, (cuuint64_t)outer, (cuuint64_t)batch};
  const cuuint64_t strides[2] = {(cuuint64_t)s_outer * 2,
                                 (cuuint64_t)(batch > 1 ? s_batch : outer * s_outer) * 2};
  const cuuint32_t box[3] = {(cuuint32_t)box_inner, (cuuint32_t)box_outer, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<bf16*>(base), dims, strides,
            box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            swizzle128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

template <bool AT, bool BT, bool CA, bool CB, bool SCATTER, int P, int BN>
inline cudaError_t launch(const GemmArgs& p, const Operands& o, const Out& out,
                          const PermSpec& s, cudaStream_t st) {
  using T = Tile<P, BN>;
  Maps maps = {};
  for (int q = 0; q < T::NP; ++q) {
    constexpr int BK = T::BK;
    const bool a =
        AT ? encode(&maps.a[q], o.a[q], p.M, p.K, p.a_sk, p.batch, p.a_sb, 64, BK, true)
           : encode(&maps.a[q], o.a[q], p.K, p.M, p.a_sm, p.batch, p.a_sb, BK, BM, BK == 64);
    const bool b =
        BT ? encode(&maps.b[q], o.b[q], p.N, p.K, p.b_sk, p.batch, p.b_sb, 64, BK, true)
           : encode(&maps.b[q], o.b[q], p.K, p.N, p.b_sn, p.batch, p.b_sb, BK, BN, BK == 64);
    if (!a || !b) return cudaErrorInvalidValue;
  }
  static PerDevice<cudaError_t> attrs;
  const cudaError_t* attr = attrs.get([] {
    return cudaFuncSetAttribute(cgemm_wgmma_kernel<AT, BT, CA, CB, SCATTER, P, BN>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::SMEM);
  });
  if (!attr) return cudaErrorInvalidDevice;
  if (*attr != cudaSuccess) return *attr;
  const dim3 grid((p.M / BM) * (p.N / BN), 1, p.batch);
  cgemm_wgmma_kernel<AT, BT, CA, CB, SCATTER, P, BN><<<grid, THREADS, T::SMEM, st>>>(maps, p, out,
                                                                                    s);
  return cudaGetLastError();
}

// Whether the product's shape takes this loop: large::pattern's (M % 128,
// N % 64, at least 128 tiles of 128 x 64), with K % 32 and unit strides.
inline bool takes_shape(long long M, long long N, long long K, long long batch) {
  if (M % BM || N % 64 || K % K_STEP || M < BM || N < 64) return false;
  return (M / BM) * (N / 64) * batch >= 128;
}

inline bool takes(const GemmArgs& p) {
  if (!takes_shape(p.M, p.N, p.K, p.batch)) return false;
  const bool ak = p.a_sk == 1, am = p.a_sm == 1, bk = p.b_sk == 1, bn = p.b_sn == 1;
  if (!(ak || am) || !(bk || bn)) return false;
  return p.scatter ? p.batch == 1 : p.c_sn == 1;
}

// The product on this loop at precision P (kHigh or kDefault), its tile
// width by shape (see the note above). A product that the loop does not
// take, or a layout and conjugation pattern outside the six of the circuit
// launchers (tn_gemm.cuh's table), is refused: nothing falls back.
template <int P>
inline cudaError_t launch_product(const GemmArgs& p, const Operands& o, const Out& out,
                                  const PermSpec& s, cudaStream_t st) {
  static_assert(P == kHigh || P == kDefault, "the wgmma loop runs the bf16 precisions");
  if (!takes(p)) return cudaErrorInvalidValue;
  const bool ak = p.a_sk == 1, bk = p.b_sk == 1, ca = p.a_conj < 0, cb = p.b_conj < 0;
  const bool wide = p.N % 128 == 0 && (long long)(p.M / BM) * (p.N / 128) * p.batch >= 264;
#define TN_WG_LAUNCH(AT, BT, CA_, CB_, SC)                                     \
  return wide ? launch<AT, BT, CA_, CB_, SC, P, 128>(p, o, out, s, st) \
              : launch<AT, BT, CA_, CB_, SC, P, 64>(p, o, out, s, st)
  if (p.scatter) {
    if (ak && bk && !ca && !cb) TN_WG_LAUNCH(false, false, false, false, true);  // X Mc^T
  } else if (ak && !bk && !ca && cb) {
    TN_WG_LAUNCH(false, true, false, true, false);  // column pull-back
  } else if (!ak && !bk && !ca && cb) {
    TN_WG_LAUNCH(true, true, false, true, false);  // dMc
  } else if (!ak && !bk && ca && !cb) {
    TN_WG_LAUNCH(true, true, true, false, false);  // row pull-back
  } else if (ak && bk && !ca && cb) {
    TN_WG_LAUNCH(false, false, false, true, false);  // dMr
  } else if (ak && !bk && !ca && !cb) {
    TN_WG_LAUNCH(false, true, false, false, false);  // forward left
  }
#undef TN_WG_LAUNCH
  return cudaErrorInvalidValue;
}

// The Operands of product p whose planes' splits are in the shadows of A's
// re and im and B's re and im planes.
template <int P>
inline Operands operands(const GemmArgs& p, const Shadow& ar, const Shadow& ai, const Shadow& br,
                         const Shadow& bi) {
  Operands o = {};
  o.a[0] = ar.hi_of(p.a_re);
  o.a[1] = ai.hi_of(p.a_im);
  o.b[0] = br.hi_of(p.b_re);
  o.b[1] = bi.hi_of(p.b_im);
  if (P == kHigh) {
    o.a[2] = ar.lo_of(p.a_re);
    o.a[3] = ai.lo_of(p.a_im);
    o.b[2] = br.lo_of(p.b_re);
    o.b[3] = bi.lo_of(p.b_im);
  }
  return o;
}

// The Out that writes C's split into the shadows of C's re and im planes.
template <int P>
inline Out split_out(const GemmArgs& p, const Shadow& cr, const Shadow& ci) {
  Out o = {};
  o.c[0] = cr.hi_of(p.c_re);
  o.c[1] = ci.hi_of(p.c_im);
  if (P == kHigh) {
    o.c[2] = cr.lo_of(p.c_re);
    o.c[3] = ci.lo_of(p.c_im);
  }
  return o;
}

}  // namespace wg
}  // namespace tn
