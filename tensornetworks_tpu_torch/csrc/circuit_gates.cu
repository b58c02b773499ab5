// The grid circuit's FP32 forward and adjoint backward as per-qubit 2x2
// gates, for sm_90a: kernels 5-6 under the kernel precision `highest`
// (ops/kernels/circuit2d_grid.py, the gate path).
//
// Replaces, under FP32 on this card, the TPU kernels of
// tensornetworks_tpu/ops/pallas/circuit2d_grid.py:
//   make_pallas_circuit2d_grid_probs -> fwd_kernel   (tn_circuit_gates_forward)
//   make_pallas_circuit2d_grid_probs -> bwd_kernel   (tn_circuit_gates_backward)
//
// Why not the TPU's design: the TPU folded a layer's n per-qubit rotations
// into two dense Kronecker operators (R x R and C x C) and applied them as
// matrix products, because its matrix unit wants dense products. On the
// H100 in FP32 there is no tensor-core path, so a dense fold is only extra
// work on the CUDA cores: 8 R C (R + C) FLOPs a layer where the gates need
// 14 n 2^n (at n = 24, 2.2e12 against 5.6e9), and its gradient, dMr = l x^H,
// is itself such a product. Here each gate is applied to its amplitude
// pairs, and the backward returns the gates' gradients.
//
// Design. The state is two FP32 planes (re, im) of the flat index, qubit q
// on bit n-1-q. A layer is a few passes (the plan: circuit2d_grid.py
// layer_gate_passes, a table of PassSpec records). A pass gives each block
// a tile of 2^k <= 4096 amplitudes, one coset of a subspace V of the flat
// index: loaded with 16-byte loads (V holds the m low bits, so runs of 2^m
// amplitudes are contiguous), held in shared memory, every gate of the pass
// applied to the pairs of tile positions that differ in its tile bit, three
// gates at a time in registers (8 amplitudes a thread), and stored back.
// The layer's CNOTs are one GF(2)-linear map M of the index and its CZs one
// sign (layer_map.cuh); both go into the store of the layer's last pass,
// whose V also holds M^-1 of the m low bits, so that M sends the tile onto
// a coset that holds them too: the stores are 16-byte runs as well. The
// first layer's load makes the input state (the Hadamard wall's uniform
// amplitude, or |0..0>), and the last store writes |x|^2 too.
// The backward runs the passes in reverse on x and the cotangent l = 2 g x
// (four planes): the map pass undoes the sign and the map in its load, and
// each gate, last to first, takes x <- U^H x, adds l_r conj(x_c) over its
// pairs into the thread's sums of dU, then l <- U^H l. Each tile's dU is
// summed over the block's threads in a fixed tree (warp shuffles, then the
// warps in order) into one record per gate; a last launch sums each gate's
// records in tile order. No float atomics: two runs give bitwise-equal dU.
//
// Bound at n = 24 (two planes of 2^24 FP32 values, 134 MB): a pass reads
// and writes the state once, 268 MB, 80 us at 3.35 TB/s; a backward pass
// moves the four planes, 160 us. The gates do 14 FLOPs an amplitude each:
// 5.6e9 a layer, 84 us at 67 TFLOP/s FP32, below a layer's 2-3 passes of
// bytes (160-240 us), so the kernels are bound by device memory, and the
// design keeps each pass to one read and one write of the state, with full
// 32-byte sectors (m >= 3; m = 2 only where it saves a pass). The shared
// memory traffic, 16 bytes an amplitude for each three gates, is below the
// device-memory bytes at the SMs' 33 TB/s. On the H100 a pass without its
// gates moves the state at the rate of a plain copy; the gates' arithmetic
// adds to that time rather than hiding under it (PERF.md §6), and the
// backward's (three times the forward's FMAs a gate) the more.

#include <cmath>

#include <cuda_runtime.h>

#include "per_device.cuh"

namespace tn {
namespace gates {

constexpr int kTileBits = 12;  // circuit2d_grid.GATE_TILE_BITS
constexpr int kTile = 1 << kTileBits;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kGroup = 3;  // circuit2d_grid.GATE_GROUP
constexpr int kMax = 32;
constexpr int kChunks = kTile / (4 * kThreads);  // a thread's 16-byte runs of a plane

// One pass (circuit2d_grid.GatePass.record): header, then the fields, each
// kMax words.
struct PassSpec {
  unsigned n, k, m, map, layer, ngates, ncz, xout;
  unsigned lin[kMax], cin[kMax], lout[kMax], cout[kMax], coff[kMax], tq[kMax];
  unsigned gate_bit[kMax], gate_qubit[kMax], gate_slot[kMax];
  unsigned cz_bit[kMax], cz_mask[kMax];
};
constexpr int kSpecWords = 8 + 11 * kMax;  // circuit2d_grid.GATE_SPEC_WORDS
static_assert(sizeof(PassSpec) == 4 * kSpecWords, "PassSpec is the record's layout");

enum : unsigned { kInit = 1, kProbs = 2, kWall = 4, kSeed = 8, kNoStore = 16, kNoMap = 32,
                  kTwo = 64 };
// xout: a constant XOR of a map pass's store address (its low 31 bits, a
// shard's rank-dependent CNOT targets), and kNegate, a sign on every
// amplitude the pass stores (the rank's constant CZ sign). Both are zero
// in a one-card plan.
constexpr unsigned kNegate = 1u << 31;

struct FwdArgs {
  const unsigned* spec;  // this pass's record, on the device
  const float* u;        // (L, n, 2, 2) complex as (re, im) floats
  const float* src_re;
  const float* src_im;
  float* dst_re;
  float* dst_im;
  float* probs;
  unsigned flags;
  float amp;  // the Hadamard wall's amplitude 2^(-n/2)
};

struct BwdArgs {
  const unsigned* spec;
  const float* u;
  const float* src[4];  // x re, x im, l re, l im; kSeed: x re, x im, g
  float* dst[4];
  float* partials;  // 8 floats a record: dU's (r, c, re|im) of one tile (block)
  unsigned flags;
};

__device__ __forceinline__ void load_spec(PassSpec& s, const unsigned* spec) {
  unsigned* w = reinterpret_cast<unsigned*>(&s);
  for (int i = threadIdx.x; i < kSpecWords; i += kThreads) w[i] = spec[i];
  __syncthreads();
}

// XOR of basis[t] over the set bits t >= from of p.
__device__ __forceinline__ unsigned span_of(unsigned p, const unsigned* basis, unsigned from,
                                            unsigned k) {
  unsigned a = 0;
  for (unsigned t = from; t < k; ++t)
    if ((p >> t) & 1u) a ^= basis[t];
  return a;
}

// The CZ sign of the layer at flat indices a..a+3 (a a multiple of 4): bit j
// set where it flips a+j. The sign is (-1)^Q(d), Q(d) = sum_k d_k popc(d &
// cz[k]) (layer_map.cuh perm_sign), a quadratic form over GF(2):
//   Q(a ^ j) = Q(a) ^ Q(j) ^ parity(j & (u ^ t)),
// u the XOR of cz[k] over a's set bits k, t's bit k parity(cz[k] & a): one
// pass over the masks for four indices.
__device__ __forceinline__ unsigned cz_flips4(const PassSpec& s, unsigned a) {
  unsigned qa = 0, w = 0, qj = 0;
  for (unsigned i = 0; i < s.ncz; ++i) {
    const unsigned k = s.cz_bit[i], c = s.cz_mask[i];
    const unsigned ak = (a >> k) & 1u, pc = __popc(a & c) & 1u;
    qa ^= ak & pc;
    w ^= (ak ? c : 0u) ^ (pc << k);
    if (k < 2)
      for (unsigned j = 1u << k; j < 4; j = (j + 1) | (1u << k)) qj ^= (__popc(c & j) & 1u) << j;
  }
  unsigned flips = 0;
#pragma unroll
  for (unsigned j = 0; j < 4; ++j) flips |= ((qa ^ (qj >> j) ^ __popc(j & w)) & 1u) << j;
  return flips;
}

struct Block {
  unsigned base_in, base_out, off;
};

__device__ __forceinline__ Block block_bases(const PassSpec& s) {
  Block b = {0u, 0u, 0u};
  for (unsigned t = 0; t + s.k < s.n; ++t)
    if ((blockIdx.x >> t) & 1u) {
      b.base_in ^= s.cin[t];
      b.base_out ^= s.cout[t];
      b.off ^= s.coff[t];
    }
  return b;
}

// The load address of tile positions p..p+3 (p a multiple of 4).
__device__ __forceinline__ unsigned in_addr(const PassSpec& s, const Block& b, unsigned p) {
  return b.base_in ^ (p & ((1u << s.m) - 1u)) ^ span_of(p, s.lin, s.m, s.k);
}

// The store address of store indices q..q+3 and their tile positions.
// Unmapped, the load's. In a shard's pass (Shard), unmapped also under
// kNoMap, and the constant XOR moves the run of four to another 16-byte
// run (its bits from 2 up) and permutes it (its bits 0-1).
template <bool Shard>
__device__ __forceinline__ unsigned out_addr(const PassSpec& s, const Block& b, unsigned q,
                                             unsigned pos[4], bool mapped) {
  if (!mapped) {
    for (int j = 0; j < 4; ++j) pos[j] = q + j;
    return in_addr(s, b, q);
  }
  const unsigned p0 = b.off ^ span_of(q, s.tq, 2, s.k);
  if constexpr (!Shard) {
    pos[0] = p0;
    pos[1] = p0 ^ s.tq[0];
    pos[2] = p0 ^ s.tq[1];
    pos[3] = p0 ^ s.tq[0] ^ s.tq[1];
    return b.base_out ^ (q & ((1u << s.m) - 1u)) ^ span_of(q, s.lout, s.m, s.k);
  } else {
    const unsigned x = s.xout & 3u;
#pragma unroll
    for (unsigned j = 0; j < 4; ++j)
      pos[j] = p0 ^ (((j ^ x) & 1u) ? s.tq[0] : 0u) ^ (((j ^ x) & 2u) ? s.tq[1] : 0u);
    return b.base_out ^ (q & ((1u << s.m) - 1u)) ^ span_of(q, s.lout, s.m, s.k) ^
           (s.xout & ~(kNegate | 3u));
  }
}

// The sign flips of the pass's store at addresses a..a+3: its CZ sign and,
// in a shard's pass, its constant one.
template <bool Shard>
__device__ __forceinline__ unsigned store_flips(const PassSpec& s, unsigned a) {
  const unsigned flips = s.ncz ? cz_flips4(s, a) : 0u;
  if constexpr (Shard) return flips ^ ((s.xout & kNegate) ? 0xFu : 0u);
  return flips;
}

// Tile position of amplitude c of group element i: zeros inserted at the
// gates' tile bits (ascending in sorted), then c's bit j at bit[j].
template <int G>
__device__ __forceinline__ unsigned group_base(unsigned i, const unsigned (&sorted)[G]) {
#pragma unroll
  for (int j = 0; j < G; ++j) {
    const unsigned b = sorted[j];
    i = ((i >> b) << (b + 1)) | (i & ((1u << b) - 1u));
  }
  return i;
}

template <int G>
__device__ __forceinline__ void sort_bits(const unsigned (&bit)[G], unsigned (&sorted)[G]) {
#pragma unroll
  for (int j = 0; j < G; ++j) sorted[j] = bit[j];
#pragma unroll
  for (int a = 0; a < G; ++a)
#pragma unroll
    for (int c = a + 1; c < G; ++c)
      if (sorted[c] < sorted[a]) {
        const unsigned t = sorted[a];
        sorted[a] = sorted[c];
        sorted[c] = t;
      }
}

// (a0, a1) <- U (a0, a1); U = (u00, u01, u10, u11) as (re, im) pairs.
__device__ __forceinline__ void gate(const float* U, float& a0r, float& a0i, float& a1r,
                                     float& a1i) {
  const float b0r = U[0] * a0r - U[1] * a0i + U[2] * a1r - U[3] * a1i;
  const float b0i = U[0] * a0i + U[1] * a0r + U[2] * a1i + U[3] * a1r;
  const float b1r = U[4] * a0r - U[5] * a0i + U[6] * a1r - U[7] * a1i;
  const float b1i = U[4] * a0i + U[5] * a0r + U[6] * a1i + U[7] * a1r;
  a0r = b0r;
  a0i = b0i;
  a1r = b1r;
  a1i = b1i;
}

// (a0, a1) <- U^H (a0, a1).
__device__ __forceinline__ void gate_h(const float* U, float& a0r, float& a0i, float& a1r,
                                       float& a1i) {
  const float b0r = U[0] * a0r + U[1] * a0i + U[4] * a1r + U[5] * a1i;
  const float b0i = U[0] * a0i - U[1] * a0r + U[4] * a1i - U[5] * a1r;
  const float b1r = U[2] * a0r + U[3] * a0i + U[6] * a1r + U[7] * a1i;
  const float b1i = U[2] * a0i - U[3] * a0r + U[6] * a1i - U[7] * a1r;
  a0r = b0r;
  a0i = b0i;
  a1r = b1r;
  a1i = b1i;
}

template <int G>
__device__ __forceinline__ void group_gates(const PassSpec& s, unsigned g0, const float* u,
                                            unsigned (&bit)[G], float (&U)[G][8]) {
#pragma unroll
  for (int j = 0; j < G; ++j) {
    bit[j] = s.gate_bit[g0 + j];
    const float* up = u + 8 * (s.layer * s.n + s.gate_qubit[g0 + j]);
#pragma unroll
    for (int r = 0; r < 8; ++r) U[j][r] = __ldg(up + r);
  }
}

// Gates g0 .. g0+G-1 of the pass on the tile, in order.
template <int G>
__device__ void apply_group(const PassSpec& s, unsigned g0, const float* u, float* re,
                            float* im) {
  unsigned bit[G], sorted[G];
  float U[G][8];
  group_gates<G>(s, g0, u, bit, U);
  sort_bits<G>(bit, sorted);
  for (unsigned i = threadIdx.x; i < (1u << (s.k - G)); i += kThreads) {
    const unsigned base = group_base<G>(i, sorted);
    float ar[1 << G], ai[1 << G];
#pragma unroll
    for (int c = 0; c < (1 << G); ++c) {
      unsigned p = base;
#pragma unroll
      for (int j = 0; j < G; ++j)
        if ((c >> j) & 1) p |= 1u << bit[j];
      ar[c] = re[p];
      ai[c] = im[p];
    }
#pragma unroll
    for (int j = 0; j < G; ++j)
#pragma unroll
      for (int c = 0; c < (1 << G); ++c)
        if (!((c >> j) & 1)) gate(U[j], ar[c], ai[c], ar[c | 1 << j], ai[c | 1 << j]);
#pragma unroll
    for (int c = 0; c < (1 << G); ++c) {
      unsigned p = base;
#pragma unroll
      for (int j = 0; j < G; ++j)
        if ((c >> j) & 1) p |= 1u << bit[j];
      re[p] = ar[c];
      im[p] = ai[c];
    }
  }
}

template <bool Shard>
__global__ void __launch_bounds__(kThreads, 3) fwd_pass_kernel(const FwdArgs a) {
  extern __shared__ __align__(16) float tile[];
  __shared__ PassSpec s;
  load_spec(s, a.spec);
  const unsigned T = 1u << s.k;
  float* re = tile;
  float* im = tile + T;
  const Block b = block_bases(s);

  // Every load of the thread in flight before the first is used.
  float4 r[kChunks], i[kChunks];
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const unsigned p = 4 * (threadIdx.x + c * kThreads);
    if (p >= T) break;
    const unsigned addr = in_addr(s, b, p);
    i[c] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (a.flags & kInit) {
      const float w = a.amp;
      r[c] = (a.flags & kWall) ? make_float4(w, w, w, w)
                               : make_float4(addr == 0 ? 1.f : 0.f, 0.f, 0.f, 0.f);
    } else {
      r[c] = __ldg(reinterpret_cast<const float4*>(a.src_re + addr));
      i[c] = __ldg(reinterpret_cast<const float4*>(a.src_im + addr));
    }
  }
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const unsigned p = 4 * (threadIdx.x + c * kThreads);
    if (p >= T) break;
    *reinterpret_cast<float4*>(re + p) = r[c];
    *reinterpret_cast<float4*>(im + p) = i[c];
  }
  __syncthreads();

  for (unsigned g0 = 0; g0 < s.ngates; g0 += kGroup) {
    const unsigned G = min(s.ngates - g0, (unsigned)kGroup);
    if (G == 3)
      apply_group<3>(s, g0, a.u, re, im);
    else if (G == 2)
      apply_group<2>(s, g0, a.u, re, im);
    else
      apply_group<1>(s, g0, a.u, re, im);
    __syncthreads();
  }

  for (unsigned q = 4 * threadIdx.x; q < T; q += 4 * kThreads) {
    unsigned pos[4];
    const unsigned addr = out_addr<Shard>(s, b, q, pos, s.map);
    const unsigned flips = store_flips<Shard>(s, addr);
    float vr[4], vi[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      vr[j] = re[pos[j]];
      vi[j] = im[pos[j]];
      if ((flips >> j) & 1u) {
        vr[j] = -vr[j];
        vi[j] = -vi[j];
      }
    }
    *reinterpret_cast<float4*>(a.dst_re + addr) = make_float4(vr[0], vr[1], vr[2], vr[3]);
    *reinterpret_cast<float4*>(a.dst_im + addr) = make_float4(vi[0], vi[1], vi[2], vi[3]);
    if (a.flags & kProbs)
      *reinterpret_cast<float4*>(a.probs + addr) =
          make_float4(vr[0] * vr[0] + vi[0] * vi[0], vr[1] * vr[1] + vi[1] * vi[1],
                      vr[2] * vr[2] + vi[2] * vi[2], vr[3] * vr[3] + vi[3] * vi[3]);
  }
}

// Sums v over the block in a fixed order: a shuffle tree in each warp,
// then the warps in order (red: kWarps x width floats). The result is
// valid in thread `slot` of width slots.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Gates g0+G-1 .. g0 of the pass undone on x and l (planes t[0..3]), last
// to first, their dU sums over this tile written as one record each.
template <int G>
__device__ void adjoint_group(const PassSpec& s, unsigned g0, const float* u, float* const* t,
                              float* red, float* partials) {
  unsigned bit[G], sorted[G];
  float U[G][8], acc[G][8];
  group_gates<G>(s, g0, u, bit, U);
  sort_bits<G>(bit, sorted);
#pragma unroll
  for (int j = 0; j < G; ++j)
#pragma unroll
    for (int r = 0; r < 8; ++r) acc[j][r] = 0.f;
  for (unsigned i = threadIdx.x; i < (1u << (s.k - G)); i += kThreads) {
    const unsigned base = group_base<G>(i, sorted);
    float xr[1 << G], xi[1 << G], lr[1 << G], li[1 << G];
#pragma unroll
    for (int c = 0; c < (1 << G); ++c) {
      unsigned p = base;
#pragma unroll
      for (int j = 0; j < G; ++j)
        if ((c >> j) & 1) p |= 1u << bit[j];
      xr[c] = t[0][p];
      xi[c] = t[1][p];
      lr[c] = t[2][p];
      li[c] = t[3][p];
    }
#pragma unroll
    for (int j = G - 1; j >= 0; --j)
#pragma unroll
      for (int c = 0; c < (1 << G); ++c) {
        if ((c >> j) & 1) continue;
        const int c1 = c | 1 << j;
        gate_h(U[j], xr[c], xi[c], xr[c1], xi[c1]);
        // dU[r][c'] += l_r conj(x_c'): (lr xr + li xi) + i (li xr - lr xi)
        const float l_r[2] = {lr[c], lr[c1]}, l_i[2] = {li[c], li[c1]};
        const float x_r[2] = {xr[c], xr[c1]}, x_i[2] = {xi[c], xi[c1]};
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int cc = 0; cc < 2; ++cc) {
            float& re = acc[j][(r * 2 + cc) * 2];
            float& im = acc[j][(r * 2 + cc) * 2 + 1];
            re = fmaf(l_i[r], x_i[cc], fmaf(l_r[r], x_r[cc], re));
            im = fmaf(-l_r[r], x_i[cc], fmaf(l_i[r], x_r[cc], im));
          }
        gate_h(U[j], lr[c], li[c], lr[c1], li[c1]);
      }
#pragma unroll
    for (int c = 0; c < (1 << G); ++c) {
      unsigned p = base;
#pragma unroll
      for (int j = 0; j < G; ++j)
        if ((c >> j) & 1) p |= 1u << bit[j];
      t[0][p] = xr[c];
      t[1][p] = xi[c];
      t[2][p] = lr[c];
      t[3][p] = li[c];
    }
  }
  const unsigned warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int j = 0; j < G; ++j)
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const float v = warp_sum(acc[j][r]);
      if (lane == 0) red[warp * kGroup * 8 + j * 8 + r] = v;
    }
  __syncthreads();
  if (threadIdx.x < G * 8) {
    float v = red[threadIdx.x];
    for (int w = 1; w < kWarps; ++w) v += red[w * kGroup * 8 + threadIdx.x];
    const unsigned j = threadIdx.x / 8, r = threadIdx.x % 8;
    partials[8ull * (s.gate_slot[g0 + j] + blockIdx.x) + r] = v;
  }
}

// A one-card pass (Shard false) takes the flags kSeed and kNoStore; a
// shard's pass also kNoMap: the pass runs as if it had no map (its map
// undone already); kTwo: two planes only (x or l, src[0..1] -> dst[0..1]),
// the map and sign undone, no gate.
template <bool Shard>
__global__ void __launch_bounds__(kThreads, 2) bwd_pass_kernel(const BwdArgs a) {
  extern __shared__ __align__(16) float tile[];
  __shared__ PassSpec s;
  __shared__ float red[kWarps * kGroup * 8];
  load_spec(s, a.spec);
  const unsigned T = 1u << s.k;
  float* t[4] = {tile, tile + T, tile + 2 * T, tile + 3 * T};
  const Block b = block_bases(s);
  const bool nomap = Shard && (a.flags & kNoMap);
  const bool mapped = s.map && !nomap;
  const bool two = Shard && (a.flags & kTwo);

  // Load through the store side of the forward pass, every load of the
  // thread in flight before the first is used; undo the sign and the map.
  float4 v[kChunks][4];
  unsigned addrs[kChunks];
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const unsigned q = 4 * (threadIdx.x + c * kThreads);
    if (q >= T) break;
    unsigned pos[4];
    addrs[c] = out_addr<Shard>(s, b, q, pos, mapped);
    if constexpr (Shard) {
      const int loads = two ? 2 : ((a.flags & kSeed) ? 3 : 4);
#pragma unroll
      for (int h = 0; h < 4; ++h)
        if (h < loads) v[c][h] = __ldg(reinterpret_cast<const float4*>(a.src[h] + addrs[c]));
    } else {
#pragma unroll
      for (int h = 0; h < 3; ++h)  // kSeed: x, g
        v[c][h] = __ldg(reinterpret_cast<const float4*>(a.src[h] + addrs[c]));
      if (!(a.flags & kSeed))
        v[c][3] = __ldg(reinterpret_cast<const float4*>(a.src[3] + addrs[c]));
    }
  }
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const unsigned q = 4 * (threadIdx.x + c * kThreads);
    if (q >= T) break;
    unsigned pos[4];
    out_addr<Shard>(s, b, q, pos, mapped);
    if (a.flags & kSeed) {  // l = 2 g x
      const float4 g = v[c][2];
      v[c][2] = make_float4(2.f * g.x * v[c][0].x, 2.f * g.y * v[c][0].y, 2.f * g.z * v[c][0].z,
                            2.f * g.w * v[c][0].w);
      v[c][3] = make_float4(2.f * g.x * v[c][1].x, 2.f * g.y * v[c][1].y, 2.f * g.z * v[c][1].z,
                            2.f * g.w * v[c][1].w);
    }
    const unsigned flips = nomap ? 0u : store_flips<Shard>(s, addrs[c]);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float sg = ((flips >> j) & 1u) ? -1.f : 1.f;
#pragma unroll
      for (int h = 0; h < 4; ++h)
        if (!two || h < 2) t[h][pos[j]] = sg * reinterpret_cast<const float*>(&v[c][h])[j];
    }
  }
  __syncthreads();

  const unsigned groups = two ? 0u : (s.ngates + kGroup - 1) / kGroup;
  for (int gi = (int)groups - 1; gi >= 0; --gi) {
    const unsigned g0 = gi * kGroup;
    const unsigned G = min(s.ngates - g0, (unsigned)kGroup);
    if (G == 3)
      adjoint_group<3>(s, g0, a.u, t, red, a.partials);
    else if (G == 2)
      adjoint_group<2>(s, g0, a.u, t, red, a.partials);
    else
      adjoint_group<1>(s, g0, a.u, t, red, a.partials);
    __syncthreads();
  }
  if (a.flags & kNoStore) return;

  for (unsigned p = 4 * threadIdx.x; p < T; p += 4 * kThreads) {
    const unsigned addr = in_addr(s, b, p);
#pragma unroll
    for (int h = 0; h < 4; ++h)
      if (!two || h < 2)
        *reinterpret_cast<float4*>(a.dst[h] + addr) = *reinterpret_cast<const float4*>(t[h] + p);
  }
}

// dU of each gate: its records summed in tile order (slots: (offset,
// count) a gate), one block a gate.
__global__ void __launch_bounds__(kThreads) reduce_kernel(const float* partials, const int* slots,
                                                          float* du) {
  __shared__ float red[kWarps * 8];
  const int off = slots[2 * blockIdx.x], count = slots[2 * blockIdx.x + 1];
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int i = threadIdx.x; i < count; i += kThreads) {
    const float4* rec = reinterpret_cast<const float4*>(partials + 8ll * (off + i));
    const float4 lo = __ldg(rec), hi = __ldg(rec + 1);
    acc[0] += lo.x;
    acc[1] += lo.y;
    acc[2] += lo.z;
    acc[3] += lo.w;
    acc[4] += hi.x;
    acc[5] += hi.y;
    acc[6] += hi.z;
    acc[7] += hi.w;
  }
  const unsigned warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const float v = warp_sum(acc[r]);
    if (lane == 0) red[warp * 8 + r] = v;
  }
  __syncthreads();
  if (threadIdx.x < 8) {
    float v = red[threadIdx.x];
    for (int w = 1; w < kWarps; ++w) v += red[w * 8 + threadIdx.x];
    du[8 * blockIdx.x + threadIdx.x] = v;
  }
}

// The global-pair combines of a state sharded over ranks (parallel/
// distributed_ansatz.py): a gate on a global qubit pairs this rank's shard
// with the partner's, whose piece the rank has received. Element i of a
// piece (local index offset + i) takes the 2x2 W of table entry
// parity(idx & m1) | parity(idx & m2) << 1 (one entry for a rotation, two
// for a CNOT whose control is a local bit: I and X), W[r][c] at coef[8e +
// 2(2r + c)] as (re, im); b is this rank's bit of the pair. Bound by device
// memory: the forward moves 24 bytes an element, the backward 48.
constexpr int kPairElems = 4 * kThreads * 4;  // a block's elements

struct PairArgs {
  float* mine[4];          // x re, x im (forward); x re, x im, l re, l im (backward)
  const float* theirs[4];  // the partner's, the same planes
  const float* coef;
  float* partials;         // backward: one record a block (dU's row b), or null
  unsigned offset, count, m1, m2, b;
};

__device__ __forceinline__ unsigned pair_entry(const PairArgs& a, unsigned idx) {
  return (__popc(idx & a.m1) & 1u) | ((__popc(idx & a.m2) & 1u) << 1);
}

// new_b = W[b][b] x_b + W[b][1-b] x_other.
__global__ void __launch_bounds__(kThreads) pair_fwd_kernel(const PairArgs a) {
  const unsigned b = a.b;
  for (unsigned i = blockIdx.x * kPairElems + 4 * threadIdx.x; i < a.count && i < (blockIdx.x + 1) * kPairElems;
       i += 4 * kThreads) {
    const float4 mr = *reinterpret_cast<const float4*>(a.mine[0] + i);
    const float4 mi = *reinterpret_cast<const float4*>(a.mine[1] + i);
    const float4 tr = __ldg(reinterpret_cast<const float4*>(a.theirs[0] + i));
    const float4 ti = __ldg(reinterpret_cast<const float4*>(a.theirs[1] + i));
    float outr[4], outi[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float* w = a.coef + 8 * pair_entry(a, a.offset + i + j);
      const float ar = __ldg(w + 2 * (2 * b + b)), ai = __ldg(w + 2 * (2 * b + b) + 1);
      const float br = __ldg(w + 2 * (2 * b + 1 - b)), bi = __ldg(w + 2 * (2 * b + 1 - b) + 1);
      const float xr = reinterpret_cast<const float*>(&mr)[j], xi = reinterpret_cast<const float*>(&mi)[j];
      const float yr = reinterpret_cast<const float*>(&tr)[j], yi = reinterpret_cast<const float*>(&ti)[j];
      outr[j] = ar * xr - ai * xi + br * yr - bi * yi;
      outi[j] = ar * xi + ai * xr + br * yi + bi * yr;
    }
    *reinterpret_cast<float4*>(a.mine[0] + i) = make_float4(outr[0], outr[1], outr[2], outr[3]);
    *reinterpret_cast<float4*>(a.mine[1] + i) = make_float4(outi[0], outi[1], outi[2], outi[3]);
  }
}

// The adjoint: x_before = W^H x_after (both halves, from the pair's
// pieces), dU[b][c] += l_b conj(x_before_c) where the pair is a gate's,
// l_before_b = (W^H l_after)_b; this rank's x and l un-computed in place.
__global__ void __launch_bounds__(kThreads) pair_bwd_kernel(const PairArgs a) {
  __shared__ float red[kWarps * 8];
  const unsigned b = a.b;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};  // dU[b][0], dU[b][1] as (re, im)
  for (unsigned i = blockIdx.x * kPairElems + 4 * threadIdx.x; i < a.count && i < (blockIdx.x + 1) * kPairElems;
       i += 4 * kThreads) {
    float4 v[8];
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      v[h] = *reinterpret_cast<const float4*>(a.mine[h] + i);
      v[4 + h] = __ldg(reinterpret_cast<const float4*>(a.theirs[h] + i));
    }
    float nx[2][4], nl[2][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float* w = a.coef + 8 * pair_entry(a, a.offset + i + j);
      float W[2][2][2];
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          W[r][c][0] = __ldg(w + 2 * (2 * r + c));
          W[r][c][1] = __ldg(w + 2 * (2 * r + c) + 1);
        }
      const float* f = reinterpret_cast<const float*>(v);
      // x and l after the gate by half (0, 1); this rank holds half b
      const float mxr = f[j], mxi = f[4 + j], mlr = f[8 + j], mli = f[12 + j];
      const float txr = f[16 + j], txi = f[20 + j], tlr = f[24 + j], tli = f[28 + j];
      const float x0r = b ? txr : mxr, x0i = b ? txi : mxi, x1r = b ? mxr : txr, x1i = b ? mxi : txi;
      const float l0r = b ? tlr : mlr, l0i = b ? tli : mli, l1r = b ? mlr : tlr, l1i = b ? mli : tli;
      float pr[2], pi[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {  // (W^H x)_c = sum_r conj(W[r][c]) x_r
        pr[c] = W[0][c][0] * x0r + W[0][c][1] * x0i + W[1][c][0] * x1r + W[1][c][1] * x1i;
        pi[c] = W[0][c][0] * x0i - W[0][c][1] * x0r + W[1][c][0] * x1i - W[1][c][1] * x1r;
        // dU[b][c] += l_b conj(x_before_c)
        acc[2 * c] = fmaf(mli, pi[c], fmaf(mlr, pr[c], acc[2 * c]));
        acc[2 * c + 1] = fmaf(-mlr, pi[c], fmaf(mli, pr[c], acc[2 * c + 1]));
      }
      nx[0][j] = b ? pr[1] : pr[0];
      nx[1][j] = b ? pi[1] : pi[0];
      // (W^H l)_b
      const float w0r = b ? W[0][1][0] : W[0][0][0], w0i = b ? W[0][1][1] : W[0][0][1];
      const float w1r = b ? W[1][1][0] : W[1][0][0], w1i = b ? W[1][1][1] : W[1][0][1];
      nl[0][j] = w0r * l0r + w0i * l0i + w1r * l1r + w1i * l1i;
      nl[1][j] = w0r * l0i - w0i * l0r + w1r * l1i - w1i * l1r;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      *reinterpret_cast<float4*>(a.mine[h] + i) = make_float4(nx[h][0], nx[h][1], nx[h][2], nx[h][3]);
      *reinterpret_cast<float4*>(a.mine[2 + h] + i) =
          make_float4(nl[h][0], nl[h][1], nl[h][2], nl[h][3]);
    }
  }
  if (!a.partials) return;
  const unsigned warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const float v = warp_sum(acc[r]);
    if (lane == 0) red[warp * 8 + r] = v;
  }
  __syncthreads();
  if (threadIdx.x < 8) {  // the record: dU (2, 2) complex, row b filled
    float v = 0.f;
    if (threadIdx.x / 4 == b) {
      v = red[threadIdx.x % 4];
      for (int w = 1; w < kWarps; ++w) v += red[w * 8 + threadIdx.x % 4];
    }
    a.partials[8ull * blockIdx.x + threadIdx.x] = v;
  }
}

// The one-time setup of this device: the backward's four planes take
// 64 KB of dynamic shared memory, above the 48 KB default. Static, not
// inline: each library of these kernels keeps its own (an inline function's
// statics are one object across the shared libraries of a process).
static cudaError_t setup() {
  static PerDevice<cudaError_t> once;
  const cudaError_t* err = once.get([] {
    const cudaError_t e = cudaFuncSetAttribute(bwd_pass_kernel<false>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               4 * kTile * (int)sizeof(float));
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(bwd_pass_kernel<true>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                4 * kTile * (int)sizeof(float));
  });
  return err ? *err : cudaErrorInvalidDevice;
}

}  // namespace gates
}  // namespace tn

extern "C" {

// u: (L, n, 2, 2) complex64 as floats; probs, xr, xi: (R, C) outputs; tmp:
// (2, R, C) scratch; spec: the plan's records (passes x kSpecWords) on the
// device, host: the same on the host. One launch a pass; each layer's last
// pass writes the other buffer (its map moves amplitudes between blocks),
// so the first layer starts in the buffer from which the layers' flips end
// in xr, xi.
int tn_circuit_gates_forward(const float* u, float* probs, float* xr, float* xi, float* tmp,
                             const unsigned* spec, const unsigned* host, int passes, int has_wall,
                             void* stream) {
  using namespace tn::gates;
  if (passes < 1) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned n = host[0];
  const unsigned layers = host[(passes - 1) * kSpecWords + 4] + 1;
  const long long size = 1ll << n;
  float* bufs[2][2] = {{xr, xi}, {tmp, tmp + size}};
  int cur = layers % 2;  // each layer flips once
  for (int p = 0; p < passes; ++p) {
    const unsigned* rec = host + p * kSpecWords;
    const unsigned k = rec[1], layer = rec[4];
    const bool last_of_layer = p + 1 == passes || host[(p + 1) * kSpecWords + 4] != layer;
    const int out = last_of_layer ? 1 - cur : cur;
    FwdArgs a;
    a.spec = spec + p * kSpecWords;
    a.u = u;
    a.src_re = bufs[cur][0];
    a.src_im = bufs[cur][1];
    a.dst_re = bufs[out][0];
    a.dst_im = bufs[out][1];
    a.probs = probs;
    a.flags = (p == 0 ? kInit : 0u) | (p + 1 == passes ? kProbs : 0u) | (has_wall ? kWall : 0u);
    a.amp = static_cast<float>(exp2(-0.5 * n));
    fwd_pass_kernel<false><<<1u << (n - k), kThreads, 2 * (1u << k) * sizeof(float), st>>>(a);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    cur = out;
  }
  return cudaSuccess;
}

// u as the forward's; xr, xi, g: (R, C) the forward's state and the
// cotangent of the probs; du: (L, n, 2, 2) complex64 as floats, out;
// buf_a, buf_b: (4, R, C) scratch; partials: the plan's records of 8
// floats; slots: (nslots, 2) int32 (offset, count) of each gate's records,
// gate (l, q) at l n + q; spec, host, passes: as the forward's. The passes
// run in reverse, each layer's last pass (the first here) from the other
// buffer; the first layer's first pass stores nothing.
int tn_circuit_gates_backward(const float* u, const float* xr, const float* xi, const float* g,
                              float* du, float* buf_a, float* buf_b, float* partials,
                              const int* slots, const unsigned* spec, const unsigned* host,
                              int passes, int nslots, void* stream) {
  using namespace tn::gates;
  if (passes < 1 || nslots < 1) return cudaErrorInvalidValue;
  cudaError_t err = setup();
  if (err != cudaSuccess) return err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long size = 1ll << host[0];
  float* bufs[2] = {buf_a, buf_b};
  int cur = -1;  // the forward's output
  for (int p = passes - 1; p >= 0; --p) {
    const unsigned* rec = host + p * kSpecWords;
    const unsigned n = rec[0], k = rec[1], layer = rec[4];
    const bool last_of_layer = p + 1 == passes || host[(p + 1) * kSpecWords + 4] != layer;
    const int out = cur < 0 ? 0 : (last_of_layer ? 1 - cur : cur);
    BwdArgs a;
    a.spec = spec + p * kSpecWords;
    a.u = u;
    if (cur < 0) {
      a.src[0] = xr;
      a.src[1] = xi;
      a.src[2] = g;
      a.src[3] = nullptr;
    } else {
      for (int h = 0; h < 4; ++h) a.src[h] = bufs[cur] + h * size;
    }
    for (int h = 0; h < 4; ++h) a.dst[h] = bufs[out] + h * size;
    a.partials = partials;
    a.flags = (cur < 0 ? kSeed : 0u) | (p == 0 ? kNoStore : 0u);
    bwd_pass_kernel<false><<<1u << (n - k), kThreads, 4 * (1u << k) * sizeof(float), st>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    cur = out;
  }
  reduce_kernel<<<nslots, kThreads, 0, st>>>(partials, slots, du);
  return cudaGetLastError();
}

// One pass of a shard's plan (ops/kernels/shard_gates.py): spec and host
// the pass's record on the device and the host; src -> dst, in place where
// the pass has no map. The plan's first pass loads an initialised state.
int tn_gates_forward_pass(const float* u, const unsigned* spec, const unsigned* host,
                          const float* src_re, const float* src_im, float* dst_re, float* dst_im,
                          void* stream) {
  using namespace tn::gates;
  FwdArgs a;
  a.spec = spec;
  a.u = u;
  a.src_re = src_re;
  a.src_im = src_im;
  a.dst_re = dst_re;
  a.dst_im = dst_im;
  a.probs = nullptr;
  a.flags = 0u;
  a.amp = 0.f;
  const unsigned n = host[0], k = host[1];
  fwd_pass_kernel<true><<<1u << (n - k), kThreads, 2 * (1u << k) * sizeof(float),
                    static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}

// The adjoint of one pass: src (x re, x im, l re, l im) -> dst, each
// gate's partials at its slot; flags kNoMap or kTwo (two planes: src[0..1]
// -> dst[0..1], the map undone, no gate) or 0.
int tn_gates_backward_pass(const float* u, const unsigned* spec, const unsigned* host,
                           const float* s0, const float* s1, const float* s2, const float* s3,
                           float* d0, float* d1, float* d2, float* d3, float* partials, int flags,
                           void* stream) {
  using namespace tn::gates;
  cudaError_t err = setup();
  if (err != cudaSuccess) return err;
  BwdArgs a;
  a.spec = spec;
  a.u = u;
  a.src[0] = s0;
  a.src[1] = s1;
  a.src[2] = s2;
  a.src[3] = s3;
  a.dst[0] = d0;
  a.dst[1] = d1;
  a.dst[2] = d2;
  a.dst[3] = d3;
  a.partials = partials;
  a.flags = static_cast<unsigned>(flags);
  const unsigned n = host[0], k = host[1];
  const int planes = (a.flags & kTwo) ? 2 : 4;
  bwd_pass_kernel<true><<<1u << (n - k), kThreads, planes * (1u << k) * sizeof(float),
                    static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}

// Each gate's partial records summed in order: slots (nslots, 2) int32.
int tn_gates_reduce(const float* partials, const int* slots, float* du, int nslots,
                    void* stream) {
  using namespace tn::gates;
  if (nslots < 1) return cudaErrorInvalidValue;
  reduce_kernel<<<nslots, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(partials, slots, du);
  return cudaGetLastError();
}

// The global-pair combines: count elements (a multiple of 4) of this
// rank's planes, in place, from the partner's; coef the W table on the
// device. The backward writes one dU record a block of kPairElems into
// partials where it is not null.
int tn_pair_forward(float* xr, float* xi, const float* tr, const float* ti, const float* coef,
                    int offset, int count, int m1, int m2, int b, void* stream) {
  using namespace tn::gates;
  if (count < 4 || count % 4) return cudaErrorInvalidValue;
  PairArgs a = {{xr, xi, nullptr, nullptr}, {tr, ti, nullptr, nullptr}, coef, nullptr,
                (unsigned)offset, (unsigned)count, (unsigned)m1, (unsigned)m2, (unsigned)b};
  pair_fwd_kernel<<<(count + kPairElems - 1) / kPairElems, kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}

int tn_pair_backward(float* xr, float* xi, float* lr, float* li, const float* txr,
                     const float* txi, const float* tlr, const float* tli, const float* coef,
                     float* partials, int offset, int count, int m1, int m2, int b,
                     void* stream) {
  using namespace tn::gates;
  if (count < 4 || count % 4) return cudaErrorInvalidValue;
  PairArgs a = {{xr, xi, lr, li}, {txr, txi, tlr, tli}, coef, partials,
                (unsigned)offset, (unsigned)count, (unsigned)m1, (unsigned)m2, (unsigned)b};
  pair_bwd_kernel<<<(count + kPairElems - 1) / kPairElems, kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}

}  // extern "C"
