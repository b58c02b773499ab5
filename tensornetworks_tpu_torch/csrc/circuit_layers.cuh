// Per-layer host launchers of the circuit forward and its adjoint backward.
// Both serve circuit2d_grid.cu alone (n >= 18: the row chain folded into Mr,
// one index map and CZ masks per layer); the n <= 17 forward and backward are one
// persistent cooperative kernel each (circuit2d_fwd.cuh, circuit2d_bwd.cuh).
//
// The state is the (R, C) = (2^ceil(n/2), 2^floor(n/2)) matrix X of planar
// FP32 (re, im) planes. A layer is X <- Mr X Mc^T followed by one exact
// GF(2)-linear index map with a CZ sign (layer_map.cuh PermSpec). Each
// launcher issues a short sequence of launches on the caller's stream and
// allocates nothing: the caller passes the outputs and the scratch.
//
// Forward, per layer: the left product into tmp, then the right product whose
// epilogue scatters through the map (and writes |psi|^2 on the last layer).
// circuit_forward first writes Mc^T into the `mct` scratch (one tiled transpose
// of all layers, both planes), so that the right products read B = Mc[l]^T
// n-contiguous (the layout the large loop copies by cp.async, tn_gemm.cuh).
// Backward, per layer in reverse: a gather undoes the map on the state and the
// cotangent lambda = 2 g psi (four planes), one batched GEMM of two pulls both
// back through conj(Mc), one through Mr^dagger, and two complex GEMMs form
// dMc = lambda^T conj(x) and dMr = lambda x^H.
//
// `precision` (a Precision code, mma_bf16.cuh) picks every product's
// instantiation: the FP32 FMA loops, or the bf16 tensor-core passes. Under
// the bf16 precisions the products that tn_gemm.cuh's large loop takes run
// on the wgmma loop of wgmma_bf16.cuh instead (circuit_forward_wg,
// circuit_backward_wg: every product from n = 20; at n = 19 all but the
// backward's dMc and the forward), which reads bf16 splits of its operand
// planes from a scratch the caller passes; the others keep tn_gemm.cuh's
// mma.sync passes on the FP32 planes. The transpose, the gathers and the
// index maps are exact at every precision.
//
// Flat state indices are 32-bit (tn_gemm.cuh `m * p.N + n`, `int S` below):
// that holds to n = 30, above every size the Python wrappers accept.

#pragma once

#include <atomic>
#include <cmath>

#include "wgmma_bf16.cuh"

namespace tn {

// The layer structure the drivers read (host tables, (layers, n) each): the
// n masks of layer l's CNOT index map at rows + l * n, its CZ masks at
// cz + l * n.
struct LayerMaps {
  int n;
  const unsigned* rows;
  const unsigned* cz;
};

inline PermSpec layer_spec(const LayerMaps& m, int layer) {
  PermSpec s = {};
  s.nbits = m.n;
  const unsigned* rows = m.rows + (long long)layer * m.n;
  const unsigned* cz = m.cz + (long long)layer * m.n;
  for (int k = 0; k < m.n; ++k) {
    s.rows[k] = rows[k];
    s.cz[k] = cz[k];
  }
  return s;
}

namespace {

__global__ void init_state_kernel(float* re, float* im, int size, float amp, int wall) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= size) return;
  re[i] = wall ? amp : (i == 0 ? 1.f : 0.f);
  im[i] = 0.f;
}

// buf planes: [x_re, x_im, l_re, l_im]; lambda = 2 g psi.
__global__ void cotangent_init_kernel(const float* xr, const float* xi, const float* g,
                                      float* buf, int size) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= size) return;
  const float a = xr[i], b = xi[i], two_g = 2.f * g[i];
  buf[i] = a;
  buf[size + i] = b;
  buf[2 * size + i] = two_g * a;
  buf[3 * size + i] = two_g * b;
}

// Inverse of the forward's scatter on all four planes: Z[i] = s(d) Y[d], d = dst(i).
__global__ void unpermute_kernel(const float* src, float* dst, int size, PermSpec spec) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= size) return;
  const unsigned d = perm_dst(spec, (unsigned)i);
  const float s = perm_sign(spec, d);
#pragma unroll
  for (int p = 0; p < 4; ++p) dst[p * size + i] = s * src[p * size + d];
}

// out[p][l] = in_p[l]^T for the planes p = re, im of (layers, C, C); 32x32
// tiles through shared memory, so that reads and writes both coalesce.
__global__ void transpose_planes_kernel(const float* re, const float* im, float* out, int C,
                                        int layers) {
  __shared__ float t[32][33];
  const int z = blockIdx.z, plane = z % 2, l = z / 2;
  const long long off = (long long)l * C * C;
  const float* src = (plane ? im : re) + off;
  float* dst = out + (long long)plane * layers * C * C + off;
  int x = blockIdx.x * 32 + threadIdx.x, y = blockIdx.y * 32 + threadIdx.y;
  for (int j = 0; j < 32; j += 8)
    if (x < C && y + j < C) t[threadIdx.y + j][threadIdx.x] = src[(long long)(y + j) * C + x];
  __syncthreads();
  x = blockIdx.y * 32 + threadIdx.x;
  y = blockIdx.x * 32 + threadIdx.y;
  for (int j = 0; j < 32; j += 8)
    if (x < C && y + j < C) dst[(long long)(y + j) * C + x] = t[threadIdx.x][threadIdx.y + j];
}

// cotangent_init_kernel, and the split of the four planes into `hi` (lo at
// hi + 4 size under kHigh): the wgmma loop's operands.
template <int P>
__global__ void cotangent_init_split_kernel(const float* xr, const float* xi, const float* g,
                                            float* buf, wg::bf16* hi, int size) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= size) return;
  const float a = xr[i], b = xi[i], two_g = 2.f * g[i];
  const float v[4] = {a, b, two_g * a, two_g * b};
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    buf[p * size + i] = v[p];
    wg::store_split<P>(hi, hi + 4LL * size, p * size + i, v[p]);
  }
}

// unpermute_kernel, and the split of dst's four planes, as above.
template <int P>
__global__ void unpermute_split_kernel(const float* src, float* dst, wg::bf16* hi, int size,
                                       PermSpec spec) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= size) return;
  const unsigned d = perm_dst(spec, (unsigned)i);
  const float s = perm_sign(spec, d);
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const float v = s * src[p * size + d];
    dst[p * size + i] = v;
    wg::store_split<P>(hi, hi + 4LL * size, p * size + i, v);
  }
}

inline int blocks_for(int size) { return (size + 255) / 256; }

}  // namespace

// The bf16 scratch (wg::bf16 elements) of the wgmma forward and backward:
// one layer's Mr and Mc planes (re, im) and the state's planes (the
// forward's X and tmp, 4 S; the backward's buf_a and buf_b, 8 S), each plane
// hi then, under kHigh, lo.
inline long long forward_split_elems(int n, int precision) {
  const long long R = 1LL << (n + 1) / 2, C = 1LL << n / 2, parts = precision == kHigh ? 2 : 1;
  return parts * (2 * R * R + 2 * C * C + 4 * R * C);
}
inline long long backward_split_elems(int n, int precision) {
  const long long R = 1LL << (n + 1) / 2, C = 1LL << n / 2, parts = precision == kHigh ? 2 : 1;
  return parts * (2 * R * R + 2 * C * C + 8 * R * C);
}

// Whether the forward's products (left: R x C x R; scatter: R x C x C) and
// the backward's pull-backs (R x C, batch 2) take the wgmma loop. The
// backward's dMc (C x C x R) and dMr (R x R x C) have no more tiles than the
// pull-backs, so they take it only where these do, each by its own shape.
inline bool forward_takes_wgmma(int n) {
  const int R = 1 << (n + 1) / 2, C = 1 << n / 2;
  return wg::takes_shape(R, C, R, 1) && wg::takes_shape(R, C, C, 1);
}
inline bool backward_takes_wgmma(int n) {
  const int R = 1 << (n + 1) / 2, C = 1 << n / 2;
  return wg::takes_shape(R, C, C, 2) && wg::takes_shape(R, C, R, 2);
}

// The bf16 products the launchers have sent to each loop, counted on the
// host at each launch: [0] tn_gemm.cuh's mma.sync passes, [1] the wgmma
// loop (read by tn_circuit2d_grid_bf16_products).
inline std::atomic<long long>* bf16_products() {
  static std::atomic<long long> counts[2];
  return counts;
}

// One product launched by launch_gemm at `precision`: a bf16 one counts on
// the mma.sync side, an FP32 one nowhere.
inline void count_mma_sync(int precision) {
  if (precision != kHighest) ++bf16_products()[0];
}

// One layer's operator planes and their shadows in the scratch `ops`.
struct LayerOps {
  const float *mr_re, *mr_im, *mc_re, *mc_im;
  wg::Shadow mr_r, mr_i, mc_r, mc_i;
};

template <int P>
inline LayerOps layer_ops(const float* mr_re, const float* mr_im, const float* mc_re,
                          const float* mc_im, wg::bf16* ops, int l, long long RR, long long CC) {
  const long long parts = P == kHigh ? 2 : 1;
  LayerOps o;
  o.mr_re = mr_re + l * RR;
  o.mr_im = mr_im + l * RR;
  o.mc_re = mc_re + l * CC;
  o.mc_im = mc_im + l * CC;
  o.mr_r = {o.mr_re, RR, ops};
  o.mr_i = {o.mr_im, RR, ops + parts * RR};
  o.mc_r = {o.mc_re, CC, ops + 2 * parts * RR};
  o.mc_i = {o.mc_im, CC, ops + 2 * parts * RR + parts * CC};
  return o;
}

template <int P>
inline cudaError_t split_layer_ops(const LayerOps& o, long long RR, long long CC,
                                   cudaStream_t st) {
  const wg::SplitJob jobs[4] = {wg::job(o.mr_r, o.mr_re, RR), wg::job(o.mr_i, o.mr_im, RR),
                                wg::job(o.mc_r, o.mc_re, CC), wg::job(o.mc_i, o.mc_im, CC)};
  return wg::split_planes<P>(jobs, 4, st);
}

// circuit_forward at the bf16 precision P, every product on the wgmma loop.
// split: forward_split_elems of scratch. The right product reads Mc[l]
// itself as a k-contiguous B: no Mc^T is formed.
template <int P>
inline cudaError_t circuit_forward_wg(const float* mr_re, const float* mr_im, const float* mc_re,
                                      const float* mc_im, float* probs, float* xr, float* xi,
                                      float* tmp, wg::bf16* split, int layers, int has_wall,
                                      const LayerMaps& maps, cudaStream_t st) {
  const int n = maps.n, rb = (n + 1) / 2, cb = n - rb;
  const int R = 1 << rb, C = 1 << cb, S = R * C;
  const long long parts = P == kHigh ? 2 : 1, RR = (long long)R * R, CC = (long long)C * C;
  const float amp = (float)std::pow(2.0, -0.5 * n);
  if (!split) return cudaErrorInvalidValue;
  wg::bf16* const xs = split + parts * (2 * RR + 2 * CC);
  const wg::Shadow sxr = {xr, S, xs}, sxi = {xi, S, xs + parts * S};
  const wg::Shadow stmp = {tmp, 2LL * S, xs + 2 * parts * S};
  init_state_kernel<<<blocks_for(S), 256, 0, st>>>(xr, xi, S, amp, has_wall);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const wg::SplitJob xjobs[2] = {wg::job(sxr, xr, S), wg::job(sxi, xi, S)};
  if ((err = wg::split_planes<P>(xjobs, 2, st)) != cudaSuccess) return err;
  const PermSpec none = {};
  for (int l = 0; l < layers; ++l) {
    const LayerOps o = layer_ops<P>(mr_re, mr_im, mc_re, mc_im, split, l, RR, CC);
    if ((err = split_layer_ops<P>(o, RR, CC, st)) != cudaSuccess) return err;
    // tmp = Mr[l] X, only its split written (the scatter product reads no
    // FP32 tmp)
    GemmArgs left = gemm_args();
    left.a_re = o.mr_re; left.a_im = o.mr_im; left.a_sm = R; left.a_sk = 1;
    left.b_re = xr; left.b_im = xi; left.b_sk = C; left.b_sn = 1;
    left.c_re = tmp; left.c_im = tmp + S; left.c_sm = C; left.c_sn = 1;
    left.M = R; left.N = C; left.K = R;
    const wg::Out tmp_split = wg::split_out<P>(left, stmp, stmp);
    left.c_re = left.c_im = nullptr;
    err = wg::launch_product<P>(left, wg::operands<P>(left, o.mr_r, o.mr_i, sxr, sxi),
                                tmp_split, none, st);
    if (err != cudaSuccess) return err;
    ++bf16_products()[1];
    // X = perm/sign(tmp Mc[l]^T), B[k, n] = Mc[l][n, k]; X's split but on
    // the last layer, which writes probs instead
    const bool last = l == layers - 1;
    GemmArgs right = gemm_args();
    right.a_re = tmp; right.a_im = tmp + S; right.a_sm = C; right.a_sk = 1;
    right.b_re = o.mc_re; right.b_im = o.mc_im; right.b_sk = 1; right.b_sn = C;
    right.c_re = xr; right.c_im = xi;
    right.M = R; right.N = C; right.K = C;
    right.scatter = 1;
    right.probs = last ? probs : nullptr;
    err = wg::launch_product<P>(right, wg::operands<P>(right, stmp, stmp, o.mc_r, o.mc_i),
                                last ? wg::Out{} : wg::split_out<P>(right, sxr, sxi),
                                layer_spec(maps, l), st);
    if (err != cudaSuccess) return err;
    ++bf16_products()[1];
  }
  return cudaSuccess;
}

// circuit_backward at the bf16 precision P with the pull-backs on the wgmma
// loop; dMc and dMr take it where their shapes do, else tn_gemm.cuh's
// mma.sync loop on the FP32 planes (which every kernel here still writes).
// split: backward_split_elems of scratch.
template <int P>
inline cudaError_t circuit_backward_wg(const float* mr_re, const float* mr_im, const float* mc_re,
                                       const float* mc_im, const float* xr, const float* xi,
                                       const float* g, float* dmr_re, float* dmr_im,
                                       float* dmc_re, float* dmc_im, float* buf_a, float* buf_b,
                                       wg::bf16* split, int layers, const LayerMaps& maps,
                                       cudaStream_t st) {
  const int n = maps.n, rb = (n + 1) / 2, cb = n - rb;
  const int R = 1 << rb, C = 1 << cb, S = R * C;
  const long long parts = P == kHigh ? 2 : 1, RR = (long long)R * R, CC = (long long)C * C;
  if (!split) return cudaErrorInvalidValue;
  wg::bf16* const sa = split + parts * (2 * RR + 2 * CC);
  const wg::Shadow shadow_a = {buf_a, 4LL * S, sa}, shadow_b = {buf_b, 4LL * S, sa + 4 * parts * S};
  const PermSpec none = {};
  cotangent_init_split_kernel<P><<<blocks_for(S), 256, 0, st>>>(xr, xi, g, buf_a, shadow_a.hi, S);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  float* A = buf_a;  // state after the current layer: [x_re, x_im, l_re, l_im]
  float* B = buf_b;
  const wg::Shadow* sA = &shadow_a;
  const wg::Shadow* sB = &shadow_b;
  for (int l = layers - 1; l >= 0; --l) {
    const LayerOps o = layer_ops<P>(mr_re, mr_im, mc_re, mc_im, split, l, RR, CC);
    if ((err = split_layer_ops<P>(o, RR, CC, st)) != cudaSuccess) return err;
    // Undo the permutation and signs: B = after the rotations, and its split.
    unpermute_split_kernel<P><<<blocks_for(S), 256, 0, st>>>(A, B, sB->hi, S,
                                                              layer_spec(maps, l));
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    // A = B conj(Mc), and its split
    GemmArgs col = gemm_args();
    col.a_re = B; col.a_im = B + S; col.a_sb = 2LL * S; col.a_sm = C; col.a_sk = 1;
    col.b_re = o.mc_re; col.b_im = o.mc_im; col.b_sk = C; col.b_sn = 1; col.b_conj = -1.f;
    col.c_re = A; col.c_im = A + S; col.c_sb = 2LL * S; col.c_sm = C; col.c_sn = 1;
    col.M = R; col.N = C; col.K = C; col.batch = 2;
    err = wg::launch_product<P>(col, wg::operands<P>(col, *sB, *sB, o.mc_r, o.mc_i),
                                wg::split_out<P>(col, *sA, *sA), none, st);
    if (err != cudaSuccess) return err;
    ++bf16_products()[1];
    // dMc[l] = lambda_after^T conj(x_before)
    GemmArgs dmc = gemm_args();
    dmc.a_re = B + 2LL * S; dmc.a_im = B + 3LL * S; dmc.a_sm = 1; dmc.a_sk = C;
    dmc.b_re = A; dmc.b_im = A + S; dmc.b_sk = C; dmc.b_sn = 1; dmc.b_conj = -1.f;
    dmc.c_re = dmc_re + l * CC; dmc.c_im = dmc_im + l * CC;
    dmc.c_sm = C; dmc.c_sn = 1;
    dmc.M = C; dmc.N = C; dmc.K = R;
    err = wg::takes(dmc) ? wg::launch_product<P>(dmc, wg::operands<P>(dmc, *sB, *sB, *sA, *sA),
                                                 wg::Out{}, none, st)
                         : launch_gemm(dmc, none, st, P);
    if (err != cudaSuccess) return err;
    ++bf16_products()[wg::takes(dmc) ? 1 : 0];
    // B = Mr^dagger A, and its split
    GemmArgs row = gemm_args();
    row.a_re = o.mr_re; row.a_im = o.mr_im; row.a_sm = 1; row.a_sk = R; row.a_conj = -1.f;
    row.b_re = A; row.b_im = A + S; row.b_sb = 2LL * S; row.b_sk = C; row.b_sn = 1;
    row.c_re = B; row.c_im = B + S; row.c_sb = 2LL * S; row.c_sm = C; row.c_sn = 1;
    row.M = R; row.N = C; row.K = R; row.batch = 2;
    err = wg::launch_product<P>(row, wg::operands<P>(row, o.mr_r, o.mr_i, *sA, *sA),
                                wg::split_out<P>(row, *sB, *sB), none, st);
    if (err != cudaSuccess) return err;
    ++bf16_products()[1];
    // dMr[l] = lambda_after x_before^H
    GemmArgs dmr = gemm_args();
    dmr.a_re = A + 2LL * S; dmr.a_im = A + 3LL * S; dmr.a_sm = C; dmr.a_sk = 1;
    dmr.b_re = B; dmr.b_im = B + S; dmr.b_sk = 1; dmr.b_sn = C; dmr.b_conj = -1.f;
    dmr.c_re = dmr_re + l * RR; dmr.c_im = dmr_im + l * RR;
    dmr.c_sm = R; dmr.c_sn = 1;
    dmr.M = R; dmr.N = R; dmr.K = C;
    err = wg::takes(dmr) ? wg::launch_product<P>(dmr, wg::operands<P>(dmr, *sA, *sA, *sB, *sB),
                                                 wg::Out{}, none, st)
                         : launch_gemm(dmr, none, st, P);
    if (err != cudaSuccess) return err;
    ++bf16_products()[wg::takes(dmr) ? 1 : 0];
    float* t = A; A = B; B = t;
    const wg::Shadow* ts = sA; sA = sB; sB = ts;
  }
  return cudaSuccess;
}

// probs, xr, xi: (R, C) outputs; tmp: (2, R, C) scratch; mct: (2, layers, C,
// C) scratch for Mc^T, which the wgmma forward does not read (it may be null
// there); split: forward_split_elems of bf16 scratch for the wgmma forward
// (null otherwise).
inline cudaError_t circuit_forward(const float* mr_re, const float* mr_im, const float* mc_re,
                                   const float* mc_im, float* probs, float* xr, float* xi,
                                   float* tmp, float* mct, wg::bf16* split, int layers,
                                   int has_wall, const LayerMaps& maps, int precision,
                                   cudaStream_t st) {
  if (precision != kHighest && forward_takes_wgmma(maps.n)) {
    if (precision == kHigh)
      return circuit_forward_wg<kHigh>(mr_re, mr_im, mc_re, mc_im, probs, xr, xi, tmp, split,
                                       layers, has_wall, maps, st);
    if (precision == kDefault)
      return circuit_forward_wg<kDefault>(mr_re, mr_im, mc_re, mc_im, probs, xr, xi, tmp, split,
                                          layers, has_wall, maps, st);
    return cudaErrorInvalidValue;
  }
  if (!mct) return cudaErrorInvalidValue;
  const int n = maps.n, rb = (n + 1) / 2, cb = n - rb;
  const int R = 1 << rb, C = 1 << cb, S = R * C;
  const float amp = (float)std::pow(2.0, -0.5 * n);
  cudaError_t err;
  const dim3 tgrid((C + 31) / 32, (C + 31) / 32, 2 * layers);
  transpose_planes_kernel<<<tgrid, dim3(32, 8), 0, st>>>(mc_re, mc_im, mct, C, layers);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const float* mct_re = mct;
  const float* mct_im = mct + (long long)layers * C * C;
  init_state_kernel<<<blocks_for(S), 256, 0, st>>>(xr, xi, S, amp, has_wall);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const PermSpec none = {};
  for (int l = 0; l < layers; ++l) {
    // tmp = Mr[l] X
    GemmArgs left = gemm_args();
    left.a_re = mr_re + (long long)l * R * R; left.a_im = mr_im + (long long)l * R * R;
    left.a_sm = R; left.a_sk = 1;
    left.b_re = xr; left.b_im = xi; left.b_sk = C; left.b_sn = 1;
    left.c_re = tmp; left.c_im = tmp + S; left.c_sm = C; left.c_sn = 1;
    left.M = R; left.N = C; left.K = R;
    if ((err = launch_gemm(left, none, st, precision)) != cudaSuccess) return err;
    count_mma_sync(precision);
    // X = perm/sign(tmp Mc[l]^T)
    GemmArgs right = gemm_args();
    right.a_re = tmp; right.a_im = tmp + S; right.a_sm = C; right.a_sk = 1;
    right.b_re = mct_re + (long long)l * C * C; right.b_im = mct_im + (long long)l * C * C;
    right.b_sk = C; right.b_sn = 1;
    right.c_re = xr; right.c_im = xi;
    right.M = R; right.N = C; right.K = C;
    right.scatter = 1;
    right.probs = (l == layers - 1) ? probs : nullptr;
    err = launch_gemm(right, layer_spec(maps, l), st, precision);
    if (err != cudaSuccess) return err;
    count_mma_sync(precision);
  }
  return cudaSuccess;
}

// xr, xi, g: (R, C) inputs; dmr_*: (layers, R, R) and dmc_*: (layers, C, C)
// outputs; buf_a, buf_b: (4, R, C) scratch each; split: backward_split_elems
// of bf16 scratch for the wgmma backward (null otherwise).
inline cudaError_t circuit_backward(const float* mr_re, const float* mr_im, const float* mc_re,
                                    const float* mc_im, const float* xr, const float* xi,
                                    const float* g, float* dmr_re, float* dmr_im, float* dmc_re,
                                    float* dmc_im, float* buf_a, float* buf_b, wg::bf16* split,
                                    int layers, const LayerMaps& maps, int precision,
                                    cudaStream_t st) {
  if (precision != kHighest && backward_takes_wgmma(maps.n)) {
    if (precision == kHigh)
      return circuit_backward_wg<kHigh>(mr_re, mr_im, mc_re, mc_im, xr, xi, g, dmr_re, dmr_im,
                                        dmc_re, dmc_im, buf_a, buf_b, split, layers, maps, st);
    if (precision == kDefault)
      return circuit_backward_wg<kDefault>(mr_re, mr_im, mc_re, mc_im, xr, xi, g, dmr_re, dmr_im,
                                           dmc_re, dmc_im, buf_a, buf_b, split, layers, maps, st);
    return cudaErrorInvalidValue;
  }
  const int n = maps.n, rb = (n + 1) / 2, cb = n - rb;
  const int R = 1 << rb, C = 1 << cb, S = R * C;
  const PermSpec none = {};
  cotangent_init_kernel<<<blocks_for(S), 256, 0, st>>>(xr, xi, g, buf_a, S);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  float* A = buf_a;  // state after the current layer: [x_re, x_im, l_re, l_im]
  float* B = buf_b;
  for (int l = layers - 1; l >= 0; --l) {
    const float* mr_r = mr_re + (long long)l * R * R;
    const float* mr_i = mr_im + (long long)l * R * R;
    const float* mc_r = mc_re + (long long)l * C * C;
    const float* mc_i = mc_im + (long long)l * C * C;
    // Undo the permutation and signs: B = after the rotations.
    unpermute_kernel<<<blocks_for(S), 256, 0, st>>>(A, B, S, layer_spec(maps, l));
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    // A = B conj(Mc): state and cotangent before the right rotation.
    GemmArgs col = gemm_args();
    col.a_re = B; col.a_im = B + S; col.a_sb = 2LL * S; col.a_sm = C; col.a_sk = 1;
    col.b_re = mc_r; col.b_im = mc_i; col.b_sk = C; col.b_sn = 1; col.b_conj = -1.f;
    col.c_re = A; col.c_im = A + S; col.c_sb = 2LL * S; col.c_sm = C; col.c_sn = 1;
    col.M = R; col.N = C; col.K = C; col.batch = 2;
    if ((err = launch_gemm(col, none, st, precision)) != cudaSuccess) return err;
    count_mma_sync(precision);
    // dMc[l] = lambda_after^T conj(x_before)
    GemmArgs dmc = gemm_args();
    dmc.a_re = B + 2LL * S; dmc.a_im = B + 3LL * S; dmc.a_sm = 1; dmc.a_sk = C;
    dmc.b_re = A; dmc.b_im = A + S; dmc.b_sk = C; dmc.b_sn = 1; dmc.b_conj = -1.f;
    dmc.c_re = dmc_re + (long long)l * C * C; dmc.c_im = dmc_im + (long long)l * C * C;
    dmc.c_sm = C; dmc.c_sn = 1;
    dmc.M = C; dmc.N = C; dmc.K = R;
    if ((err = launch_gemm(dmc, none, st, precision)) != cudaSuccess) return err;
    count_mma_sync(precision);
    // B = Mr^dagger A: state and cotangent before the layer.
    GemmArgs row = gemm_args();
    row.a_re = mr_r; row.a_im = mr_i; row.a_sm = 1; row.a_sk = R; row.a_conj = -1.f;
    row.b_re = A; row.b_im = A + S; row.b_sb = 2LL * S; row.b_sk = C; row.b_sn = 1;
    row.c_re = B; row.c_im = B + S; row.c_sb = 2LL * S; row.c_sm = C; row.c_sn = 1;
    row.M = R; row.N = C; row.K = R; row.batch = 2;
    if ((err = launch_gemm(row, none, st, precision)) != cudaSuccess) return err;
    count_mma_sync(precision);
    // dMr[l] = lambda_after x_before^H
    GemmArgs dmr = gemm_args();
    dmr.a_re = A + 2LL * S; dmr.a_im = A + 3LL * S; dmr.a_sm = C; dmr.a_sk = 1;
    dmr.b_re = B; dmr.b_im = B + S; dmr.b_sk = 1; dmr.b_sn = C; dmr.b_conj = -1.f;
    dmr.c_re = dmr_re + (long long)l * R * R; dmr.c_im = dmr_im + (long long)l * R * R;
    dmr.c_sm = R; dmr.c_sn = 1;
    dmr.M = R; dmr.N = R; dmr.K = C;
    if ((err = launch_gemm(dmr, none, st, precision)) != cudaSuccess) return err;
    count_mma_sync(precision);
    float* t = A; A = B; B = t;
  }
  return cudaSuccess;
}

}  // namespace tn
