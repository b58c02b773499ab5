// The bf16 variants (kernel precision `high` and `default`, mma_bf16.cuh) of
// the persistent n <= 17 circuit backward, redesigned for Hopper: one
// cooperative launch, operands split once into bf16 planes, TMA copies of
// whole-K tiles, tensor-core products from bf16 shared-memory tiles, one
// wave per phase.
//
// Replaces, at those precisions, the TPU kernel bwd_kernel of
// tensornetworks_tpu/ops/pallas/circuit2d.py:227 (the adjoint sweep,
// tn_circuit2d_backward). The FP32 kernel (circuit2d_bwd.cuh) keeps
// `highest`; the forward's bf16 variants stay the units of circuit_units.cuh
// (the forward redesigned this way was slower than those: PERF.md).
//
// Bound at n=16, bn L=8 (R = C = 256): the backward's 6L complex products
// of 256^3, 24 L (R^2 C + R C^2) real FLOPs a pass, are 19.5 us under
// `high` (three passes) at 989 TFLOP/s and 6.5 us under `default`; the
// bytes (operators, state and gradients in FP32, 2.7 us at 3.35 TB/s) are
// less. The 3L grid barriers (about 1.3 us each on the H100) add a floor of
// about 32 us. What held the earlier bf16 units (mma.sync inside the FP32
// units) at 2.6-7% of the bound, and what this design does about it:
//
// 1. The split. Each FP32 plane was rounded (and split) to bf16 in the K
//    loop, by every unit that read it. Here every layer's Mr and Mc are
//    split once per call into a bf16 scratch the wrapper allocates (hi =
//    bf16_rn(x) and, under `high`, lo = bf16_rn(x - hi):
//    precision.split_bf16's values), in the first unpermute phase, which a
//    grid barrier ends. Every epilogue that writes a state plane a later
//    product reads writes that plane's split instead: the unpermute (it
//    moves split planes: a sign flips hi and lo exactly), V and W. FP32
//    planes are written only where something reads them: dMr/dMc. No K loop
//    converts.
// 2. Tiles. A unit's operand tiles come whole (all of K) into shared memory
//    by TMA (cp.async.bulk.tensor; tensor maps encoded once per call: the
//    operands do not move during it), one box holding all of a tile's
//    planes over a 64-k slab (k-contiguous tiles) or a K piece
//    (m/n-contiguous ones), one mbarrier a piece (up to four), so that the
//    products start on the first piece; a ninth warp (its lane 0) issues
//    the boxes, since an issue holds its thread for about a microsecond
//    and a computing warp held so delays its share of the product. Tiles
//    keep their global orientation under TMA's 128-,
//    64- or 32-byte swizzle, and ldmatrix reads them (.trans for an
//    m/n-contiguous operand) free of bank conflicts. A static operator's
//    tile is requested before the barrier that opens its phase: Mc[l]'s
//    columns and Mr[l]^H's rows. Below n = 10 (R or C < 32: a box wider
//    than the tensor) the tiles are filled element by element: the shape
//    decides, the same units run.
// 3. Products. mma.sync.m16n8k16 bf16 (a 64-row wgmma tile would leave
//    under 32 units a phase at n=16), one 16 x 16 warp tile (one batch
//    element) a warp, all of K or a fixed share of its k16 steps; the
//    shares of a tile are added in share order through shared memory, each
//    share's warp finishing a quarter of the tile. Each k16 step's four
//    real products run their passes as four independent chains from zero,
//    and the step's sums are added to the FP32 accumulators by FADD (the
//    promotion rule of mma_bf16.cuh). No float atomics: a call repeats bit
//    for bit.
// 4. Waves. A phase's units are the column blocks ("items", runs of 8
//    columns) times cs row slices: 128 units a phase at n=16 on 132 SMs,
//    one wave (the FP32 kernel's bf16 units took two). The index maps and
//    CZ signs come from byte tables per layer (ByteMap), built while the
//    preceding barrier waits. n=17: the units loop over 16 column blocks.
// 5. Barriers. The kernel keeps three grid barriers a layer (3L). A form
//    with a cluster barrier between each layer's two pull-backs (2L) was
//    measured slower on the H100, which holds only 15 clusters of 8 blocks
//    at this shared memory, so that the items had to be padded: PERF.md has
//    both forms' times.
//
// Flat state indices are 32-bit, as in circuit_layers.cuh.

#pragma once

#include <cooperative_groups.h>
#include <cuda.h>  // CUtensorMap and its enums; the encoder comes from the runtime

#include <cstdint>

#include "circuit_units.cuh"
#include "layer_map.cuh"
#include "mma_bf16.cuh"
#include "per_device.cuh"

namespace tn {
namespace b16 {

namespace cg = cooperative_groups;
typedef unsigned short u16;  // bf16 bits

// A block: WARPS warps compute, one more (the producer, its lane 0) issues
// the TMA copies, so that no computing warp waits on a copy's issue.
constexpr int WARPS = 8, THREADS = 32 * (WARPS + 1), PRODUCER = 32 * WARPS;
constexpr int SMEM_MAX = 232448;  // a block's shared memory on the H100 (227 KB)
constexpr int SMEM_DYN = SMEM_MAX - 8192;  // less the static tables (PermSpec, ByteMap)

template <int P>
struct Parts {
  static constexpr int NP = P == kHigh ? 2 : 1;  // hi, and lo under kHigh
};

__host__ __device__ __forceinline__ int round16(int x) { return (x + 15) / 16 * 16; }
__host__ __device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }

// Element e of FP32 plane q of a split buffer of planes of S elements, part
// h (0 hi, 1 lo): (q NP + h) S + e.

// x's hi (and, under kHigh, lo) at p and p + sh.
template <int P>
__device__ __forceinline__ void put(u16* p, long long sh, float x) {
  unsigned hi, lo;
  mma::split<P>(x, 0.f, hi, lo);
  p[0] = (u16)hi;
  if constexpr (P == kHigh) p[sh] = (u16)lo;
}

// The same for (x0, x1) at p, p + 1 (p 4-byte aligned).
template <int P>
__device__ __forceinline__ void put2(u16* p, long long sh, float x0, float x1) {
  unsigned hi, lo;
  mma::split<P>(x0, x1, hi, lo);
  *reinterpret_cast<unsigned*>(p) = hi;
  if constexpr (P == kHigh) *reinterpret_cast<unsigned*>(p + sh) = lo;
}

// The split of count (a multiple of 4) FP32 elements: hi at dst, lo at dst +
// sh; every thread of the grid, four elements at a time.
template <int P>
__device__ void split_range(const float* src, u16* dst, long long sh, long long count) {
  const long long step = 4LL * gridDim.x * THREADS;
  for (long long i = 4LL * (blockIdx.x * THREADS + threadIdx.x); i < count; i += step) {
    const float4 v = *reinterpret_cast<const float4*>(src + i);
    unsigned h0, l0, h1, l1;
    mma::split<P>(v.x, v.y, h0, l0);
    mma::split<P>(v.z, v.w, h1, l1);
    *reinterpret_cast<uint2*>(dst + i) = make_uint2(h0, h1);
    if constexpr (P == kHigh) *reinterpret_cast<uint2*>(dst + sh + i) = make_uint2(l0, l1);
  }
}

// A layer's index map and CZ sign by bytes of the index (n <= 17: three),
// built per layer from its PermSpec: the map is GF(2)-linear, dst(i) =
// dst[0][i & 255] ^ dst[1][(i >> 8) & 255] ^ dst[2][i >> 16], and so is
// v(d) = XOR of cz[k] over the set bits k of d, in which the sign is
// (-1)^popc(d & v(d)) (sum_k d_k popc(d & cz[k]) = popc(d & v(d)) mod 2):
// three lookups each where layer_map.cuh's loops walk n bits.
struct ByteMap {
  unsigned dst[3][256], v[3][256];
};

__device__ void build_map(ByteMap& m, const PermSpec& spec) {
  for (int e = threadIdx.x; e < 3 * 256; e += THREADS) {
    const unsigned i = (unsigned)(e & 255) << (8 * (e >> 8));
    unsigned v = 0;
    for (int k = 0; k < spec.nbits; ++k)
      if ((i >> k) & 1u) v ^= spec.cz[k];
    m.dst[e >> 8][e & 255] = perm_dst(spec, i);
    m.v[e >> 8][e & 255] = v;
  }
  __syncthreads();
}

__device__ __forceinline__ unsigned map_dst(const ByteMap& m, unsigned i) {
  return m.dst[0][i & 255] ^ m.dst[1][(i >> 8) & 255] ^ m.dst[2][(i >> 16) & 255];
}

__device__ __forceinline__ float map_sign(const ByteMap& m, unsigned d) {
  const unsigned v = m.v[0][d & 255] ^ m.v[1][(d >> 8) & 255] ^ m.v[2][(d >> 16) & 255];
  return (__popc(d & v) & 1) ? -1.f : 1.f;
}

// ------------------------------------------------------------ tiles

// An operand of a product: on the TMA path a tensor map of its split planes
// (k-contiguous: coordinates (k, row, plane); m/n-contiguous: (row, k,
// plane)), on the element path (n < 6) the planes themselves: element
// (row r, k) of batch b, component c (0 re, 1 im), part h at p + b sb + c sc
// + h sh + r srow + k sk. The tile's rows are m (A) or n (B). mn: rows are
// contiguous, else k is. rows, K: the extents.
struct Src {
  const u16* p;
  long long sb, sc, sh, srow, sk;
  int rows, K;
  bool mn;
};

// A unit's copy of an operand in shared memory, in the layout TMA writes
// with one box a K piece: planes (batch, component, part) of stored rows (k
// if mn, else the tile's rows) of 16-byte chunks, in blocks: a
// k-contiguous tile in 64-k slabs, [slab][plane][row][<= 128 bytes]; an
// m/n-contiguous tile in its K pieces, [piece][plane][k of the piece][tile
// width]. Chunk c of row r sits at chunk c ^ swz_of(r) of its row: TMA's
// 128-, 64- and 32-byte swizzles for rows of 8, 4 and 2 chunks, under which
// the same chunk of 8 consecutive rows lands on 8 distinct 16-byte bank
// groups.
struct Tile {
  uint32_t base;
  int rows;   // stored rows a plane of a block: the tile's rows, or k of a piece
  int lw;     // log2 of the chunks of a stored row
  int plane;  // bytes between planes
  int block;  // bytes between slabs or pieces
  bool mn;
};

__host__ __device__ __forceinline__ int log2i(int x) {  // x a power of two
  int l = 0;
  while ((1 << l) < x) ++l;
  return l;
}

// The K pieces of a unit: one a 64-k slab (a k-contiguous tile's boxes span
// a slab), up to four; piece p holds steps [steps p / np, steps (p + 1) / np).
__host__ __device__ __forceinline__ int pieces(int kp) {
  return kp <= 64 ? 1 : (kp / 64 < 4 ? kp / 64 : 4);
}
__host__ __device__ __forceinline__ int piece_step(int steps, int np, int p) {
  return steps * p / np;
}

// The tile of an operand with `planes` planes, tile_rows rows (m or n) and
// K padded to kp.
__device__ __forceinline__ Tile make_tile(uint32_t base, bool mn, int tile_rows, int kp,
                                          int planes) {
  Tile t;
  t.base = base;
  t.mn = mn;
  if (mn) {
    t.rows = kp / pieces(kp);
    t.lw = log2i(tile_rows / 8);
  } else {
    t.rows = tile_rows;
    t.lw = log2i((kp < 64 ? kp : 64) / 8);
  }
  t.plane = t.rows << (t.lw + 4);
  t.block = planes * t.plane;
  return t;
}

__device__ __forceinline__ int swz_of(int r, int lw) {
  return lw == 3 ? (r & 7) : (r >> (3 - lw)) & ((1 << lw) - 1);
}

// Byte offset of chunk c of stored row r of plane pl: r the tile's row and
// c the chunk along k (k-contiguous), or r the k and c the chunk along the
// tile's rows (m/n-contiguous).
__device__ __forceinline__ uint32_t at(const Tile& t, int pl, int r, int c) {
  int blk, rr, cc;
  if (t.mn) {
    blk = r / t.rows; rr = r % t.rows; cc = c;
  } else {
    blk = c >> t.lw; rr = r; cc = c & ((1 << t.lw) - 1);
  }
  return t.base + blk * t.block + pl * t.plane + (((rr << t.lw) + (cc ^ swz_of(rr, t.lw))) << 4);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// The element path (n < 6: a row is shorter than 16 bytes): the whole tile
// (rows r0 .. r0 + tr, zero from min(rlim, s.rows); K padded to kp; nb
// batches) by ordinary loads and shared stores.
template <int P>
__device__ void copy_elements(const Src& s, int r0, int tr, int rlim, int kp, int nb,
                              const Tile& t) {
  constexpr int NP = Parts<P>::NP;
  const int cpr = (s.mn ? tr : kp) / 8;  // chunks along the tile's rows or k
  const int per = (s.mn ? kp : tr) * cpr, rows = s.rows < rlim ? s.rows : rlim;
  for (int i = threadIdx.x; i < per * nb * 2 * NP; i += THREADS) {
    const int pl = i / per, j = i % per, sr = j / cpr, ch = j % cpr;
    const int b = pl / (2 * NP), c = (pl / NP) % 2, h = pl % NP;
    const int row = s.mn ? r0 + 8 * ch : r0 + sr, k = s.mn ? sr : 8 * ch;
    const u16* base = s.p + b * s.sb + c * s.sc + h * s.sh;
    unsigned v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      unsigned pair = 0;
#pragma unroll
      for (int f = 0; f < 2; ++f) {
        const int r = s.mn ? row + 2 * e + f : row, kk = s.mn ? k : k + 2 * e + f;
        if (r < rows && kk < s.K)
          pair |= (unsigned)base[(long long)r * s.srow + (long long)kk * s.sk] << (16 * f);
      }
      v[e] = pair;
    }
    asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(at(t, pl, sr, ch)), "r"(v[0]),
                 "r"(v[1]), "r"(v[2]), "r"(v[3])
                 : "memory");
  }
}

// ------------------------------------------------------------ TMA

// TMA copies the tiles from n = 10 (R, C >= 32: every box within the
// tensor's extents); below, the element path.
__host__ __device__ __forceinline__ bool uses_tma(int n) { return n >= 10; }

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Until the barrier's phase of parity `parity` has completed; a wait of
// 2^34 cycles (about 9 s; a piece takes microseconds) traps, so that a lost
// copy ends the launch with an error and does not hold the card.
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
    if (!done && clock64() - start > (1LL << 34)) __trap();
  } while (!done);
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint64_t* bar,
                                         int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// A unit's operand tile and where it comes from: the tensor map (TMA path)
// with the map coordinates of the operand's row (m/n) 0 and k 0 (c_row) and
// of its batch 0's first plane (c_plane); a box holds all of the tile's
// planes and rows over a slab (k-contiguous) or a K piece (m/n-contiguous).
struct Load {
  Src s;
  Tile t;
  int r0, tr, rlim, nb;
  const CUtensorMap* map;
  int c_row, c_plane;
};

// The copies of one operand tile into shared memory, one mbarrier a K piece
// (bars[p]); started by the producer thread (the TMA path) or by every thread (the
// element path, which needs the block barrier product() passes at its
// first piece).
template <int P>
__device__ void load_tile(const Load& l, int kp, bool tma, uint64_t* bars) {
  if (!tma) {
    copy_elements<P>(l.s, l.r0, l.tr, l.rlim, kp, l.nb, l.t);
    return;
  }
  if (threadIdx.x != PRODUCER) return;
  const int np = pieces(kp), kw = kp / np;
  const int per = l.s.mn ? 1 : kw / (kp < 64 ? kp : 64);  // boxes a piece
  for (int p = 0; p < np; ++p) mbar_expect_tx(&bars[p], (uint32_t)(per * l.t.block));
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // after ldmatrix reads
  for (int blk = 0; blk < np * per; ++blk) {
    const int p = blk / per;
    const int c0 = l.s.mn ? l.r0 : blk * 64, c1 = l.s.mn ? l.c_row + p * kw : l.c_row + l.r0;
    tma_load(l.t.base + blk * l.t.block, l.map, &bars[p], c0, c1, l.c_plane);
  }
}

// The tensor maps of a kernel's parameter (a struct of CUtensorMap) into
// the TMA unit's descriptor cache, once at the start.
template <class Maps>
__device__ __forceinline__ void prefetch_maps(const Maps& m) {
  if (threadIdx.x == PRODUCER) {
    const CUtensorMap* p = reinterpret_cast<const CUtensorMap*>(&m);
    for (int i = 0; i < (int)(sizeof(Maps) / sizeof(CUtensorMap)); ++i)
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(p + i))
                   : "memory");
  }
}

__device__ __forceinline__ void ldsm4(uint32_t a, unsigned (&r)[4], bool trans) {
  if (trans)
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(a)
                 : "memory");
  else
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(a)
                 : "memory");
}

// A lane's ldmatrix address in plane 0 of a tile at k16 step s:
// k-contiguous, base + slab (c >> lw) + (((c & w) ^ sw) << 4), c = 2 s + c0
// (the lane's row fixed, its chunk moving); m/n-contiguous, base + piece
// (s >> ls) + (s & (steps a piece - 1)) step (its chunk and its swizzle
// fixed: rows move by 16, a multiple of the swizzle's period).
struct Lane {
  int base, c0, sw, step, lw, ls, block;
  bool kmaj;
  __device__ __forceinline__ uint32_t at(int s) const {
    if (!kmaj) return base + (s >> ls) * block + (s & ((1 << ls) - 1)) * step;
    const int c = 2 * s + c0, w = (1 << lw) - 1;
    return base + (c >> lw) * block + (((c & w) ^ sw) << 4);
  }
};

__device__ __forceinline__ Lane lane_at(const Tile& t, int r, int c0) {
  Lane l = {};
  l.kmaj = !t.mn;
  l.lw = t.lw;
  l.block = t.block;
  if (t.mn) {  // r: the lane's k within a step, c0: its chunk
    l.base = ((r << t.lw) + (c0 ^ swz_of(r, t.lw))) << 4;
    l.step = 16 << (t.lw + 4);
    l.ls = log2i(t.rows / 16);
  } else {  // r: the lane's row, c0: its chunk within a step
    l.base = (r << t.lw) << 4;
    l.c0 = c0;
    l.sw = swz_of(r, t.lw);
  }
  return l;
}

// The A fragment (16 rows from m0, x4): k-contiguous, lanes 0-7 rows m0..
// at k, 8-15 rows m0 + 8.., 16-31 the same rows 8 k further; m-contiguous
// (.trans), lanes 0-7 k 0-7 at m0, 8-15 k 0-7 at m0 + 8, 16-31 k 8-15.
__device__ __forceinline__ Lane lane_a(const Tile& t, int m0) {
  const int L = threadIdx.x & 31;
  return t.mn ? lane_at(t, (L & 7) + (L >> 4) * 8, (m0 >> 3) + ((L >> 3) & 1))
              : lane_at(t, m0 + (L & 7) + ((L >> 3) & 1) * 8, L >> 4);
}

// The B fragments of two 8-column tiles from n0 (x4: registers 0-1 the
// tile at n0, 2-3 the tile at n0 + 8): k-contiguous, lanes 0-7 rows n0..
// at k, 8-15 the same rows at k + 8, 16-31 rows n0 + 8..; n-contiguous
// (.trans), lanes 0-7 k 0-7 and 8-15 k 8-15 at n0, 16-31 at n0 + 8.
__device__ __forceinline__ Lane lane_b(const Tile& t, int n0) {
  const int L = threadIdx.x & 31;
  return t.mn ? lane_at(t, (L & 7) + ((L >> 3) & 1) * 8, (n0 >> 3) + (L >> 4))
              : lane_at(t, n0 + (L & 7) + (L >> 4) * 8, (L >> 3) & 1);
}

// ------------------------------------------------------------ a unit

// One k16 step of a complex product (a 16 x 8 tile) at precision P: its
// four real products (ar br, ai bi, ar bi, ai br), each P's passes chained
// from zero on the tensor cores, into sums[0..3], the signs (ca / cb = -1
// for a conjugated A / B) carried by B's fragments (exact):
//   re = sums[0] + sums[1] = ar br - (ca cb) ai bi,
//   im = sums[2] + sums[3] = cb ar bi + ca ai br.
// Four independent chains of one (kDefault) or three (kHigh) mma, where
// mma_bf16.cuh's complex_product chains re's and im's six; the step's sums
// are then added to the FP32 accumulators by FADD, its promotion rule.
template <int P, bool CA, bool CB>
__device__ __forceinline__ void step_passes(float (&sums)[4][4], const mma::FragA& ar,
                                            const mma::FragA& ai, const mma::FragB& br,
                                            const mma::FragB& bi) {
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e) sums[q][e] = 0.f;
  mma::real_product<P, false>(sums[0], ar, br);
  mma::real_product<P, CA == CB>(sums[1], ai, bi);
  mma::real_product<P, CB>(sums[2], ar, bi);
  mma::real_product<P, CA>(sums[3], ai, br);
}

// The output tile of a unit: rows m0 .. m0 + tm, columns n0 .. n0 + tn
// (multiples of 16), nb batch elements; stored only below
// m_end and n_end (the unit's item, the product's extent).
struct Out {
  int m0, n0, tm, tn, nb, m_end, n_end;
};

// Warp tiles (batch, 16 rows, 16 columns) of an output tile (tm, tn
// multiples of 16; at most 8), and the warps that share one tile's k16
// steps.
__host__ __device__ __forceinline__ int warp_tiles(int tm, int tn, int nb) {
  return nb * (tm / 16) * (tn / 16);
}
__host__ __device__ __forceinline__ int k_shares(int tiles) { return WARPS / tiles; }

// The product of a unit whose operand tiles a, b are (being) copied. On the
// TMA path it waits at each piece for the mbarriers of the tiles it was
// given fresh (Waits: region A's pieces at bars 0-3, B's at 4-7, their
// phases one bit each); on the element path it passes a block barrier.
// Warp w takes warp tile w % tiles (16 x 16: A's fragments against two of
// B's) and the k16 steps s with s % KS == w / tiles, KS = k_shares warps
// sharing a tile, whose sums are added in share order through red, each of
// the KS warps finishing a share of the tile's elements. Calls store(b, m,
// n, re0, im0, re1, im1) for the pairs (m, n), (m, n + 1) below m_end and
// n_end. Ends with a block barrier (shared memory free again).
struct Waits {
  bool tma, a, b;      // the path; tiles to wait for
  uint64_t* bars;      // region A's pieces at 0..3, region B's at 4..7
  uint32_t* ph;        // their phases (one bit each)
};

template <int P, bool CA, bool CB, class Store>
__device__ void product(const Load& la, bool a_batched, const Load& lb, bool b_batched,
                        const Out& o, int kp, float* red, const Waits& wt_, Store store) {
  constexpr int NP = Parts<P>::NP;
  const Tile& ta = la.t;
  const Tile& tb = lb.t;
  const int mt = o.tm / 16, nt = o.tn / 16, tiles = warp_tiles(o.tm, o.tn, o.nb);
  const int ks_n = k_shares(tiles);
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const bool computes = warp < WARPS;  // the producer warp only joins the barriers
  const int wt = warp % tiles, ks = warp / tiles;
  const int b = wt / (mt * nt), mi = wt / nt % mt, ni = wt % nt;
  const int steps = kp / 16, np = pieces(kp);
  const Lane fa = lane_a(ta, 16 * mi), fb = lane_b(tb, 16 * ni);
  const uint32_t pa = ta.base + (a_batched ? b : 0) * 2 * NP * ta.plane;
  const uint32_t pb = tb.base + (b_batched ? b : 0) * 2 * NP * tb.plane;
  const bool at = la.s.mn, bt = lb.s.mn;
  float re[2][4], im[2][4];  // [8-column tile j][element]
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      re[j][e] = 0.f;
      im[j][e] = 0.f;
    }
  for (int p = 0; p < np; ++p) {
    if (!wt_.tma) {
      if (p == 0) __syncthreads();
    } else if (computes) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (!(r ? wt_.b : wt_.a)) continue;
        const int bit = 4 * r + p;
        mbar_wait(&wt_.bars[bit], (*wt_.ph >> bit) & 1u);
        *wt_.ph ^= 1u << bit;
      }
    }
    const int s0 = piece_step(steps, np, p), s1 = piece_step(steps, np, p + 1);
    for (int s = s0 + ((ks - s0) & (ks_n - 1)); computes && s < s1; s += ks_n) {
      const uint32_t oa = pa + fa.at(s), ob = pb + fb.at(s);
      mma::FragA ar = {}, ai = {};
      mma::FragB br[2] = {}, bi[2] = {};
      unsigned q[4];
      ldsm4(oa, ar.hi, at);
      ldsm4(oa + NP * ta.plane, ai.hi, at);
      ldsm4(ob, q, bt);
      br[0].hi[0] = q[0]; br[0].hi[1] = q[1]; br[1].hi[0] = q[2]; br[1].hi[1] = q[3];
      ldsm4(ob + NP * tb.plane, q, bt);
      bi[0].hi[0] = q[0]; bi[0].hi[1] = q[1]; bi[1].hi[0] = q[2]; bi[1].hi[1] = q[3];
      if constexpr (P == kHigh) {
        ldsm4(oa + ta.plane, ar.lo, at);
        ldsm4(oa + 3 * ta.plane, ai.lo, at);
        ldsm4(ob + tb.plane, q, bt);
        br[0].lo[0] = q[0]; br[0].lo[1] = q[1]; br[1].lo[0] = q[2]; br[1].lo[1] = q[3];
        ldsm4(ob + 3 * tb.plane, q, bt);
        bi[0].lo[0] = q[0]; bi[0].lo[1] = q[1]; bi[1].lo[0] = q[2]; bi[1].lo[1] = q[3];
      }
      float sums[2][4][4];
#pragma unroll
      for (int j = 0; j < 2; ++j) step_passes<P, CA, CB>(sums[j], ar, ai, br[j], bi[j]);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          re[j][e] += sums[j][0][e] + sums[j][1][e];
          im[j][e] += sums[j][2][e] + sums[j][3][e];
        }
    }
  }
  const int g = lane >> 2, t2 = 2 * (lane & 3);
  // element pair q = 2 j + h of the lane: row g + 8 h, columns 8 j + t2, + 1
  auto finish = [&](int q, float r0, float i0, float r1, float i1) {
    const int j = q >> 1, h = q & 1;
    const int m = o.m0 + 16 * mi + g + 8 * h, n = o.n0 + 16 * ni + 8 * j + t2;
    if (m < o.m_end && n < o.n_end) store(b, m, n, r0, i0, r1, i1);
  };
  if (ks_n > 1) {  // the shares of a tile, added in share order; warp (tile, ks) finishes
    float* r = red + ((ks * tiles + wt) * 32 + lane) * 16;  // the pairs q with q % KS == ks
#pragma unroll
    for (int j = 0; j < 2 && computes; ++j) {
      *reinterpret_cast<float4*>(r + 8 * j) = make_float4(re[j][0], re[j][1], re[j][2], re[j][3]);
      *reinterpret_cast<float4*>(r + 8 * j + 4) =
          make_float4(im[j][0], im[j][1], im[j][2], im[j][3]);
    }
    __syncthreads();
    for (int q = ks; computes && q < 4; q += ks_n) {
      const int j = q >> 1, h = q & 1, e0 = 8 * j + 2 * h;
      float v[4] = {0.f, 0.f, 0.f, 0.f};  // re0, re1, im0, im1
      for (int k2 = 0; k2 < ks_n; ++k2) {
        const float* o2 = red + ((k2 * tiles + wt) * 32 + lane) * 16;
        const float2 rr = *reinterpret_cast<const float2*>(o2 + e0);
        const float2 ii = *reinterpret_cast<const float2*>(o2 + e0 + 4);
        if (k2 == 0) {
          v[0] = rr.x; v[1] = rr.y; v[2] = ii.x; v[3] = ii.y;
        } else {
          v[0] += rr.x; v[1] += rr.y; v[2] += ii.x; v[3] += ii.y;
        }
      }
      finish(q, v[0], v[2], v[1], v[3]);
    }
  } else if (computes) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = q >> 1, h = q & 1;
      finish(q, re[j][2 * h], im[j][2 * h], re[j][2 * h + 1], im[j][2 * h + 1]);
    }
  }
  __syncthreads();
}

// The first element of item c of `items` spread evenly over `groups` runs
// of q elements.
__host__ __device__ __forceinline__ int span_lo(int c, int items, int groups, int q) {
  return q * (int)((long long)groups * c / items);
}

// ------------------------------------------------------------ plans

// A launch's shape, chosen on the host by bwd_plan below (the library
// exports it as tn_circuit2d_bwd_bf16_plan; circuit2d.py's bf16_plan mirrors
// it for the CPU tests, and chip_smoke.py holds the two equal): cs blocks a
// set, each a share of the rows in tiles of t1 = 32 or 16, and sms / cs sets
// (one block an SM); items = column blocks of runs of 8 columns cut evenly
// over the sets, t0 = tile columns (a power of two, at least 16); at n=17
// 16-column items, looped; t2: dMc's tile rows.
struct Plan {
  int cs, items, t0, t1, t2;
  size_t smem;
};

constexpr size_t RED_BYTES = WARPS * 32 * 16 * 4;  // the share sums

__host__ __device__ __forceinline__ int pow2_at_least(int x) {
  int p = 1;
  while (p < x) p *= 2;
  return p;
}

template <int P>
__host__ __device__ inline size_t bwd_region_a(int n, int tmb, int tmc) {
  constexpr int NP = Parts<P>::NP;
  const int rb = (n + 1) / 2, cb = n - rb, kpr = round16(1 << rb), kpc = round16(1 << cb);
  const size_t e = 2 * NP * 2;                 // bytes an element of one batch's planes
  size_t r = 2 * e * tmb * kpc;                // phi2: U rows, batch 2
  r = r > e * kpr * tmb ? r : e * kpr * tmb;   // phi3: Mr^H
  r = r > e * 32 * kpc ? r : e * 32 * kpc;     // dMr: V's lambda rows
  r = r > e * kpr * tmc ? r : e * kpr * tmc;   // dMc: U's lambda columns
  return r;
}

template <int P>
__host__ __device__ inline size_t bwd_region_b(int n, int tnb) {
  constexpr int NP = Parts<P>::NP;
  const int rb = (n + 1) / 2, cb = n - rb, kpr = round16(1 << rb), kpc = round16(1 << cb);
  const size_t e = 2 * NP * 2;
  size_t r = e * kpc * tnb;                           // phi2: Mc columns
  r = r > 2 * e * kpr * tnb ? r : 2 * e * kpr * tnb;  // phi3: V columns, batch 2
  r = r > e * 32 * kpc ? r : e * 32 * kpc;            // dMr: W's x rows
  r = r > e * kpr * 32 ? r : e * kpr * 32;            // dMc: V's x columns
  return r;
}

// sms: the card's SMs.
template <int P>
inline Plan bwd_plan(int n, int sms) {
  const int rb = (n + 1) / 2, cb = n - rb, R = 1 << rb, C = 1 << cb;
  const int groups = C >= 8 ? C / 8 : 1;
  Plan p = {};
  p.cs = R / 32 < 1 ? 1 : (R / 32 > 8 ? 8 : R / 32);  // every block has row tiles
  p.t2 = R > 256 ? 16 : 32;
  const int sets = sms / p.cs, spread = groups < sets ? groups : sets;
  const int wide = 8 * pow2_at_least(cdiv(groups, spread));
  const int options[2][2] = {{spread, wide > 16 ? wide : 16}, {groups / 2 > 1 ? groups / 2 : 1, 16}};
  const int tmbs[2] = {32, 16};
  for (const auto& opt : options)
    for (int tmb : tmbs) {
      const size_t smem = bwd_region_a<P>(n, tmb, p.t2) + bwd_region_b<P>(n, opt[1]) + RED_BYTES;
      if (smem <= (size_t)SMEM_DYN && tmb <= (R > 16 ? R : 16)) {
        p.items = opt[0];
        p.t0 = opt[1];
        p.t1 = tmb;
        p.smem = smem;
        return p;
      }
    }
  return p;  // items == 0: no plan fits
}

// u16 elements of the split scratch: Mr and Mc of every layer, then the
// state: U[0], U[1], V, W with the cotangent's planes.
template <int P>
inline long long split_elems(int n, int layers) {
  const int rb = (n + 1) / 2, cb = n - rb;
  const long long R = 1LL << rb, C = 1LL << cb;
  return 2LL * Parts<P>::NP * (layers * (R * R + C * C) + 8 * R * C);
}

// ------------------------------------------------------------ the backward

// Dynamic shared memory is aligned here to 1024 bytes (the 128-byte
// swizzle's period); the launch asks 1 KB more than the regions take.
__device__ __forceinline__ uint8_t* aligned(uint8_t* p) {
  return reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

__device__ __forceinline__ void init_bars(uint64_t* bars) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < 8; ++i) mbar_init(&bars[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// Generic-proxy stores a later TMA copy reads (another block's, after a
// barrier) are ordered before it.
__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

// The backward's tensor maps (TMA path) over every state plane (U[0], U[1],
// V, W: planes x_re, x_im, l_re, l_im, each its parts): k-contiguous in
// boxes of tmb rows (phi2's U rows) and of 32 rows (the gradients' V and W
// rows); m/n-contiguous tnb wide (phi3's V columns), tmc wide (dMc's U
// columns) and 32 wide (dMc's V columns); Mc n-contiguous tnb wide (phi2)
// and Mr m-contiguous tmb wide (phi3's Mr^H).
struct BwdMaps {
  CUtensorMap st_k_tmb, st_k_32, st_mn_tnb, st_mn_tmc, st_mn_32, mc, mr;
};

struct BwdArgs {
  const float* mr_re; const float* mr_im; const float* mc_re; const float* mc_im;
  const float* xr; const float* xi; const float* g;
  float* dmr_re; float* dmr_im; float* dmc_re; float* dmc_im;
  u16* split;              // the scratch (split_elems): Mr, Mc, U[0], U[1], V, W
  const unsigned* masks;   // (2 layers, n): layer l's row masks, then its CZ masks
  int n, layers;
  Plan plan;
};

template <int P>
__global__ void __launch_bounds__(THREADS, 1)
    circuit2d_bwd_bf16_kernel(const __grid_constant__ BwdMaps maps, BwdArgs a) {
  constexpr int NP = Parts<P>::NP;
  extern __shared__ uint8_t smem_raw[];
  __shared__ PermSpec spec;
  __shared__ ByteMap bmap;
  __shared__ uint64_t bars[8];
  cg::grid_group grid = cg::this_grid();

  const int n = a.n, rb = (n + 1) / 2, cb = n - rb, L = a.layers;
  const int R = 1 << rb, C = 1 << cb, S = R * C;
  const int kpr = round16(R), kpc = round16(C);
  const long long LRR = (long long)L * R * R, LCC = (long long)L * C * C;
  const long long PS = (long long)NP * S;  // one FP32 plane's split
  u16* const mr = a.split;
  u16* const mc = mr + 2LL * NP * LRR;
  u16* const U[2] = {mc + 2LL * NP * LCC, mc + 2LL * NP * LCC + 4 * PS};
  u16* const V = U[1] + 4 * PS;
  u16* const W = V + 4 * PS;
  const bool tma = uses_tma(n);
  const int cs = a.plan.cs, tnb = a.plan.t0, tmb = a.plan.t1, tmc = a.plan.t2;
  const int units = a.plan.items * cs, row_tiles = cdiv(R, tmb);
  const int groups = C >= 8 ? C / 8 : 1, q = C >= 8 ? 8 : C;
  const size_t ra = bwd_region_a<P>(n, tmb, tmc), rbb = bwd_region_b<P>(n, tnb);
  uint8_t* const smem = aligned(smem_raw);
  const uint32_t sa = smem_u32(smem), sb = sa + (uint32_t)ra;
  float* const red = reinterpret_cast<float*>(smem + ra + rbb);
  init_bars(bars);
  if (tma) prefetch_maps(maps);
  uint32_t ph = 0;
  auto waits = [&](bool wa, bool wb) { return Waits{tma, wa, wb, bars, &ph}; };
  // the map plane of state buffer `buf` (0 U[0], 1 U[1], 2 V, 3 W), batch 0
  auto plane_of = [&](int buf) { return buf * 4 * NP; };

  auto cols_of = [&](int u, int& n0, int& n1) {
    n0 = span_lo(u / cs, a.plan.items, groups, q);
    n1 = span_lo(u / cs + 1, a.plan.items, groups, q);
  };
  auto store_split = [&](u16* buf) {
    return [=](int b, int m, int nn, float r0, float i0, float r1, float i1) {
      const long long e = (long long)m * C + nn;
      put2<P>(buf + 2 * b * PS + e, S, r0, r1);
      put2<P>(buf + (2 * b + 1) * PS + e, S, i0, i1);
    };
  };
  // phi2's B: Mc[l] columns n0.. (B[k][n] = Mc[k][n], conjugated)
  auto mc_load = [&](int l, int u) {
    int n0, n1;
    cols_of(u, n0, n1);
    return Load{{mc + l * (long long)C * C, 0, NP * LCC, LCC, 1, C, C, C, true},
                make_tile(sb, true, tnb, kpc, 2 * NP), n0, tnb, n1, 1, &maps.mc, l * C, 0};
  };
  // phi3's A: Mr[l]^H rows m0.. (A[m][k] = conj(Mr[k][m]), m-contiguous)
  auto mr_load = [&](int l, int rt) {
    return Load{{mr + l * (long long)R * R, 0, NP * LRR, LRR, 1, R, R, R, true},
                make_tile(sa, true, tmb, kpr, 2 * NP), rt * tmb, tmb, R, 1, &maps.mr, l * R, 0};
  };

  // V[rows, n0:n1] = U rows conj(Mc[l][:, n0:n1]), each row tile of unit u
  auto col_pull = [&](int l, int u, bool mc_in) {
    const Load B = mc_load(l, u);
    if (!mc_in) load_tile<P>(B, kpc, tma, bars + 4);
    bool wait_b = true;
    for (int rt = u % cs; rt < row_tiles; rt += cs) {
      const Load A = {{U[l & 1], 2 * PS, PS, S, C, 1, R, C, false},
                      make_tile(sa, false, tmb, kpc, 4 * NP), rt * tmb, tmb, R, 2, &maps.st_k_tmb,
                      0, plane_of(l & 1)};
      load_tile<P>(A, kpc, tma, bars);
      product<P, false, true>(A, true, B, false, Out{A.r0, B.r0, tmb, tnb, 2, R, B.rlim}, kpc,
                              red, waits(true, wait_b), store_split(V));
      wait_b = false;
    }
    fence_async();
  };
  // W[rows, n0:n1] = Mr[l]^H V[:, n0:n1], each row tile of unit u
  auto row_pull = [&](int l, int u, bool mr_in) {
    int n0, n1;
    cols_of(u, n0, n1);
    const Load B = {{V, 2 * PS, PS, S, 1, C, C, R, true}, make_tile(sb, true, tnb, kpr, 4 * NP), n0,
                    tnb, n1, 2, &maps.st_mn_tnb, 0, plane_of(2)};
    bool first = true;
    for (int rt = u % cs; rt < row_tiles; rt += cs) {
      const Load A = mr_load(l, rt);
      if (!mr_in) load_tile<P>(A, kpr, tma, bars);
      mr_in = false;
      if (first) load_tile<P>(B, kpr, tma, bars + 4);
      product<P, true, false>(A, false, B, true, Out{A.r0, n0, tmb, tnb, 2, R, n1}, kpr, red,
                              waits(true, first), store_split(W));
      first = false;
    }
    fence_async();
  };
  // dMr[l] = l_V x_W^H (32 x 32 units), dMc[l] = l_U^T conj(x_V) (tmc x 32)
  auto grads = [&](int l) {
    const int tr = cdiv(R, 32), nc = cdiv(C, 32), total = tr * tr + cdiv(C, tmc) * nc;
    for (int t = blockIdx.x; t < total; t += gridDim.x) {
      const bool dmr = t < tr * tr;
      const int t2 = dmr ? t : t - tr * tr;
      Load A, B;
      int tm, kp, M;
      float *dre, *dim;
      if (dmr) {
        tm = 32; kp = kpc; M = R;
        A = {{V + 2 * PS, 0, PS, S, C, 1, R, C, false}, make_tile(sa, false, 32, kpc, 2 * NP),
             t2 / tr * 32, 32, R, 1, &maps.st_k_32, 0, plane_of(2) + 2 * NP};  // l_V rows
        B = {{W, 0, PS, S, C, 1, R, C, false}, make_tile(sb, false, 32, kpc, 2 * NP),
             t2 % tr * 32, 32, R, 1, &maps.st_k_32, 0, plane_of(3)};  // x_W rows
        dre = a.dmr_re + l * (long long)R * R;
        dim = a.dmr_im + l * (long long)R * R;
      } else {
        tm = tmc; kp = kpr; M = C;
        A = {{U[l & 1] + 2 * PS, 0, PS, S, 1, C, C, R, true}, make_tile(sa, true, tmc, kpr, 2 * NP),
             t2 / nc * tmc, tmc, C, 1, &maps.st_mn_tmc, 0, plane_of(l & 1) + 2 * NP};  // l_U
        B = {{V, 0, PS, S, 1, C, C, R, true}, make_tile(sb, true, 32, kpr, 2 * NP),
             t2 % nc * 32, 32, C, 1, &maps.st_mn_32, 0, plane_of(2)};  // x_V columns
        dre = a.dmc_re + l * (long long)C * C;
        dim = a.dmc_im + l * (long long)C * C;
      }
      load_tile<P>(A, kp, tma, bars);
      load_tile<P>(B, kp, tma, bars + 4);
      product<P, false, true>(A, false, B, false, Out{A.r0, B.r0, tm, 32, 1, M, M}, kp, red,
                              waits(true, true),
                              [&](int, int m, int nn, float r0, float i0, float r1, float i1) {
                                const long long e = (long long)m * M + nn;
                                *reinterpret_cast<float2*>(dre + e) = make_float2(r0, r1);
                                *reinterpret_cast<float2*>(dim + e) = make_float2(i0, i1);
                              });
    }
  };

  bool mc_in = false;  // phi2's first Mc columns are in flight
  unit::load_spec(spec, a.masks, n, L - 1);
  build_map(bmap, spec);
  for (int l = L - 1; l >= 0; --l) {
    // phi1: undo layer l's index map and signs into U[l % 2] (split planes),
    // and the previous layer's gradients; on the first layer, the split of
    // every Mr and Mc and the unpermute of x and 2 g x
    u16* const u = U[l & 1];
    if (l == L - 1) {
      split_range<P>(a.mr_re, mr, LRR, LRR);
      split_range<P>(a.mr_im, mr + NP * LRR, LRR, LRR);
      split_range<P>(a.mc_re, mc, LCC, LCC);
      split_range<P>(a.mc_im, mc + NP * LCC, LCC, LCC);
    }
    for (int i = blockIdx.x * THREADS + threadIdx.x; i < S; i += gridDim.x * THREADS) {
      const unsigned d = map_dst(bmap, (unsigned)i);
      const float s = map_sign(bmap, d);
      if (l == L - 1) {  // the forward's output: x and lambda = 2 g x
        const float xr = a.xr[d], xi = a.xi[d], two_g = 2.f * a.g[d];
        put<P>(u + i, S, s * xr);
        put<P>(u + PS + i, S, s * xi);
        put<P>(u + 2 * PS + i, S, s * (two_g * xr));
        put<P>(u + 3 * PS + i, S, s * (two_g * xi));
      } else {  // a sign flips hi and lo exactly
        const u16 flip = s < 0.f ? 0x8000 : 0;
#pragma unroll
        for (int pl = 0; pl < 4 * NP; ++pl)
          u[pl * (long long)S + i] = W[pl * (long long)S + d] ^ flip;
      }
    }
    fence_async();
    if (l < L - 1) {
      grads(l + 1);
      if (blockIdx.x < units) {  // phi2's Mc columns, before the barrier
        load_tile<P>(mc_load(l, blockIdx.x), kpc, tma, bars + 4);
        mc_in = true;
      }
    }
    grid.sync();

    // phi2: V = U conj(Mc[l]); phi3: W = Mr[l]^H V (state and cotangent)
    for (int u2 = blockIdx.x; u2 < units; u2 += gridDim.x) {
      col_pull(l, u2, mc_in);
      mc_in = false;
    }
    const bool pre = blockIdx.x < units && blockIdx.x % cs < row_tiles;
    if (pre)  // phi3's first Mr^H rows, before the barrier
      load_tile<P>(mr_load(l, blockIdx.x % cs), kpr, tma, bars);
    grid.sync();
    for (int u2 = blockIdx.x; u2 < units; u2 += gridDim.x) {
      row_pull(l, u2, pre && u2 == blockIdx.x);
    }
    if (l > 0) {  // the next layer's map, while the barrier waits
      unit::load_spec(spec, a.masks, n, l - 1);
      build_map(bmap, spec);
    }
    grid.sync();
  }
  grads(0);
}

// ------------------------------------------------------------ launches

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, fetched by cudaGetDriverEntryPoint (null where the
// installed CUDA does not give it), so that the library needs no -lcuda.
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

// bf16 planes as a (inner, outer, planes) tensor (outer stride s_outer,
// plane stride s_plane, in elements), in boxes of (box_inner, box_outer,
// box_planes) swizzled as wide as a box row (32, 64 or 128 bytes). False if
// the encoder is missing or refuses.
inline bool encode(CUtensorMap* map, const u16* base, long long inner, long long outer,
                   long long s_outer, long long planes, long long s_plane, int box_inner,
                   int box_outer, int box_planes) {
  const EncodeTiled fn = encode_tiled();
  if (!fn) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)inner, (cuuint64_t)outer, (cuuint64_t)planes};
  const cuuint64_t strides[2] = {(cuuint64_t)s_outer * 2, (cuuint64_t)s_plane * 2};
  const cuuint32_t box[3] = {(cuuint32_t)box_inner, (cuuint32_t)box_outer,
                             (cuuint32_t)box_planes};
  const cuuint32_t unit[3] = {1, 1, 1};
  const int bytes = 2 * box_inner;
  const CUtensorMapSwizzle sw = bytes == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                : bytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                              : CU_TENSOR_MAP_SWIZZLE_32B;
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<u16*>(base), dims, strides, box,
            unit, CU_TENSOR_MAP_INTERLEAVE_NONE, sw, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The k of a box row of a k-contiguous tile (a slab, or all of a narrower
// K), and the k of a box of an m/n-contiguous tile (a piece).
inline int slab_k(int kp) { return kp < 64 ? kp : 64; }
inline int piece_k(int kp) { return kp / pieces(kp); }

template <int P>
inline bool bwd_maps(BwdMaps* m, const BwdArgs& a, const Plan& p) {
  constexpr int NP = Parts<P>::NP;
  const int rb = (a.n + 1) / 2, cb = a.n - rb;
  const long long R = 1LL << rb, C = 1LL << cb, S = R * C, L = a.layers;
  const int kpr = round16((int)R), kpc = round16((int)C);
  const u16* mr = a.split;
  const u16* mc = mr + 2 * NP * L * R * R;
  const u16* st = mc + 2 * NP * L * C * C;  // U[0], U[1], V, W
  const long long planes = 16 * NP;
  return encode(&m->st_k_tmb, st, C, R, C, planes, S, slab_k(kpc), p.t1, 4 * NP) &&
         encode(&m->st_k_32, st, C, R, C, planes, S, slab_k(kpc), 32, 2 * NP) &&
         encode(&m->st_mn_tnb, st, C, R, C, planes, S, p.t0, piece_k(kpr), 4 * NP) &&
         encode(&m->st_mn_tmc, st, C, R, C, planes, S, p.t2, piece_k(kpr), 2 * NP) &&
         encode(&m->st_mn_32, st, C, R, C, planes, S, 32, piece_k(kpr), 2 * NP) &&
         encode(&m->mc, mc, C, L * C, C, 2 * NP, L * C * C, p.t0, piece_k(kpc), 2 * NP) &&
         encode(&m->mr, mr, R, L * R, R, 2 * NP, L * R * R, p.t1, piece_k(kpr), 2 * NP);
}

// A cached launch: its plan, grid and the error that rules it out.
struct Launch {
  cudaError_t err;
  Plan plan;
  int grid;
};

// The launch of `kernel` at n, asked once per device (per_device.cuh): one
// block an SM, at most the plan's units.
template <class Maps, class Args>
inline Launch plan_launch(void (*kernel)(Maps, Args), Plan (*plan_of)(int, int), int n) {
  Launch r = {};
  r.err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_DYN);
  int dev = 0, sms = 0, occ = 0;
  if (r.err == cudaSuccess) r.err = cudaGetDevice(&dev);
  if (r.err == cudaSuccess) r.err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (r.err == cudaSuccess)
    r.err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, THREADS, SMEM_DYN);
  if (r.err == cudaSuccess && occ < 1) r.err = cudaErrorCooperativeLaunchTooLarge;
  if (r.err != cudaSuccess) return r;
  r.plan = plan_of(n, sms);
  if (r.plan.items < 1 || r.plan.smem + 1024 > (size_t)SMEM_DYN) r.err = cudaErrorInvalidValue;
  const int units = r.plan.items * r.plan.cs;
  r.grid = units < sms ? units : sms;
  return r;
}

// One cooperative launch.
template <class Maps, class Args>
inline cudaError_t launch(void (*kernel)(Maps, Args), const Launch& l, const Maps& maps, Args a,
                          cudaStream_t st) {
  a.plan = l.plan;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(l.grid);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = l.plan.smem + 1024;  // 1 KB to align it
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, maps, a);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <int P>
inline cudaError_t backward(BwdArgs a, cudaStream_t st) {
  static PerDevice<Launch> launches[18];
  const Launch* l = launches[a.n].get(
      [&] { return plan_launch(circuit2d_bwd_bf16_kernel<P>, bwd_plan<P>, a.n); });
  if (!l) return cudaErrorInvalidDevice;
  if (l->err != cudaSuccess) return l->err;
  BwdMaps maps = {};
  if (uses_tma(a.n) && !bwd_maps<P>(&maps, a, l->plan)) return cudaErrorInvalidValue;
  return launch(circuit2d_bwd_bf16_kernel<P>, *l, maps, a, st);
}

}  // namespace b16
}  // namespace tn
