// Grid-over-layers circuit forward and adjoint backward for n >= 18, FP32 on
// planar (re, im) planes, for sm_90a.
//
// Replaces the TPU kernels of tensornetworks_tpu/ops/pallas/circuit2d_grid.py:
//   make_pallas_circuit2d_grid_probs -> fwd_kernel   (tn_circuit2d_grid_forward)
//   make_pallas_circuit2d_grid_probs -> bwd_kernel   (tn_circuit2d_grid_backward)
//
// What the TPU design was for, and what stands in its place here:
// - The TPU made the layer loop its grid so that one Mosaic program held one
//   layer and the (R, C) state stayed in VMEM between steps. On the H100 each
//   rotation is already one grid-wide GEMM launch (circuit_layers.cuh), and
//   the layer loop is a loop of launches on the host.
//   At n=20 (R=C=1024) one plane pair is 8 MB and the left product's
//   scratch another 8 MB: both stay in the 50 MB L2 between a layer's
//   launches, while each layer's operators (P_row Mr and Mc, 8 MB) stream
//   through once.
// - The TPU folded the row-chain permutation into the streamed operator
//   (P_row Mr); the caller does the same, as a row gather. The boundary CNOT,
//   the column-chain permutation and the ring CNOT ran there as dense one-dot
//   W forms (X - 2 m o (X W)); here they compose into one exact GF(2) index
//   map of the flat index (`rows`), applied with the CZ sign in the right
//   GEMM's epilogue. A W form computes a permutation with R x R x C FMAs,
//   as many as a rotation; the index map costs no arithmetic.
// - The TPU chose the CZ mask in the kernel by the grid step's parity; here
//   `rows` and `cz` hold one row per layer, (layers, n), and the driver reads
//   row l. bn_structured (which the JAX package runs on XLA, not on this
//   kernel) folds nothing into Mr, and its index maps alternate: the DAG
//   edges' CNOTs on even layers, the identity on odd ones.
// - The backward walks the layers in reverse as the TPU's reversed grid did:
//   a gather undoes the map on the state and the cotangent, one batched GEMM of
//   two pulls both back, two complex GEMMs emit dMr[l] and dMc[l].
//
// Bound at n=20, L=4 (R=C=1024), as the dense products it performs:
//   forward : 8 L (R^2 C + R C^2) = 6.9e10 FLOP FP32 -> 1.03 ms at 67 TFLOP/s
//   backward: 24 L (R^2 C + R C^2) = 2.1e11 FLOP FP32 -> 3.08 ms
//   bytes: operators 2 L (R^2 + C^2) floats, 67 MB -> 20 us at 3.35 TB/s.
// Both are bound by FP32 FMA throughput at the default precision. Under the
// kernel precision `high` and `default` every product runs on the bf16
// tensor cores instead: 3 and 1 passes, bound at 989 TFLOP/s by 3x and 1x
// the dense products' operations. Which loop runs which product:
//   - FP32 (`highest`): from n=19 every non-scatter product has at least 128
//     tiles of 128x64 and takes tn_gemm.cuh's large loop (cp.async
//     pipeline, 8x4 complex register tiles); from n=20 the forward's right
//     product does too, with the scatter epilogue (the CNOT map split as
//     dst(m*N) ^ dst(n), the sign per element, scalar stores into the
//     L2-resident state). The forward first transposes Mc into a scratch
//     the wrapper passes (64 MB moved at n=20), so that the right product's
//     B is n-contiguous and streams by cp.async like the left product's.
//     The n=18 products and the n=19 scatter product (32 and 64 tiles)
//     keep the 64x64 or 32x32 configuration of the first loop.
//   - bf16 (`high`, `default`): the shapes that the large loop takes run on
//     the TMA + wgmma loop of wgmma_bf16.cuh, which reads bf16 splits of
//     the operand planes from a scratch the wrapper passes (`split`) and
//     reads Mc itself in the forward (no Mc^T); the others (n=18; at n=19
//     the forward and dMc) keep the first loop's mma.sync passes
//     (mma_bf16.cuh) and, in the forward, the Mc^T scratch.

#include "circuit_layers.cuh"

extern "C" {

// (P_row Mr): (layers, R, R) planes; Mc: (layers, C, C) planes.
// probs, xr, xi: (R, C) outputs; tmp: (2, R, C) and mct: (2, layers, C, C)
// scratch (mct may be null where the wgmma forward runs:
// tn_circuit2d_grid_split_elems); split: that many bf16 of scratch, or
// null.
// rows: (layers, n) masks of each layer's index map (HE: the boundary /
// column-chain / ring map on every layer); cz: (layers, n) CZ masks of each
// layer. Both are host tables. precision: a tn::Precision code.
int tn_circuit2d_grid_forward(const float* mr_re, const float* mr_im, const float* mc_re,
                              const float* mc_im, float* probs, float* xr, float* xi,
                              float* tmp, float* mct, void* split, int n, int layers,
                              int has_wall, int precision, const unsigned* rows,
                              const unsigned* cz, void* stream) {
  const tn::LayerMaps maps = {n, rows, cz};
  return tn::circuit_forward(mr_re, mr_im, mc_re, mc_im, probs, xr, xi, tmp, mct,
                             static_cast<tn::wg::bf16*>(split), layers, has_wall, maps, precision,
                             static_cast<cudaStream_t>(stream));
}

// xr, xi, g: (R, C) inputs; dmr_*: (layers, R, R) and dmc_*: (layers, C, C)
// outputs (gradients of the P_row-folded operators); buf_a, buf_b: (4, R, C)
// scratch each; split, precision, rows, cz: as the forward's.
int tn_circuit2d_grid_backward(const float* mr_re, const float* mr_im, const float* mc_re,
                               const float* mc_im, const float* xr, const float* xi,
                               const float* g, float* dmr_re, float* dmr_im, float* dmc_re,
                               float* dmc_im, float* buf_a, float* buf_b, void* split, int n,
                               int layers, int precision, const unsigned* rows,
                               const unsigned* cz, void* stream) {
  const tn::LayerMaps maps = {n, rows, cz};
  return tn::circuit_backward(mr_re, mr_im, mc_re, mc_im, xr, xi, g, dmr_re, dmr_im, dmc_re,
                              dmc_im, buf_a, buf_b, static_cast<tn::wg::bf16*>(split), layers,
                              maps, precision, static_cast<cudaStream_t>(stream));
}

// The bf16 scratch (elements) of the forward (backward = 0) or the backward
// (1) at n and precision: 0 where its products do not run on the wgmma loop
// (then the forward needs mct).
long long tn_circuit2d_grid_split_elems(int n, int backward, int precision) {
  if (precision != tn::kHigh && precision != tn::kDefault) return 0;
  if (backward) return tn::backward_takes_wgmma(n) ? tn::backward_split_elems(n, precision) : 0;
  return tn::forward_takes_wgmma(n) ? tn::forward_split_elems(n, precision) : 0;
}

// The bf16 products launched so far by this library's forward and backward,
// by loop: out[0] on tn_gemm.cuh's mma.sync passes, out[1] on the wgmma
// loop.
void tn_circuit2d_grid_bf16_products(long long* out) {
  out[0] = tn::bf16_products()[0].load();
  out[1] = tn::bf16_products()[1].load();
}

}  // extern "C"

// One product on the wgmma loop (tn_grid_bf16_product) at precision P.
template <int P>
static int bf16_product(tn::GemmArgs& p, const float* a, long long a_elems, const float* b,
                        long long b_elems, tn::wg::bf16* split, int do_split,
                        const tn::PermSpec& spec, cudaStream_t st) {
  const long long parts = P == tn::kHigh ? 2 : 1;
  const tn::wg::Shadow sa = {a, a_elems, split}, sb = {b, b_elems, split + parts * a_elems};
  if (do_split) {
    const tn::wg::SplitJob jobs[2] = {tn::wg::job(sa, a, a_elems), tn::wg::job(sb, b, b_elems)};
    const cudaError_t err = tn::wg::split_planes<P>(jobs, 2, st);
    if (err != cudaSuccess) return err;
  }
  return tn::wg::launch_product<P>(p, tn::wg::operands<P>(p, sa, sa, sb, sb), tn::wg::Out{}, spec,
                                   st);
}

extern "C" {

// One product on the wgmma loop, for the checks and timings of chip_smoke.py
// (ops/kernels/circuit2d_grid.py grid_product): A's planes at offsets
// offs[0], offs[1] of the FP32 buffer a (a_elems), B's at offs[2], offs[3]
// of b (b_elems), C's at offs[4], offs[5] of c; strides (elements): a_sb,
// a_sm, a_sk, b_sb, b_sk, b_sn, c_sb, c_sm; conj: bit 0 conjugates A, bit 1
// B; rows (host, nbits masks; cz may be null): the scatter epilogue through
// that map, with |C|^2 into probs if not null. split: (2 for high, 1 for
// default) x (a_elems + b_elems) bf16, a's split then b's, written first
// when do_split.
int tn_grid_bf16_product(const float* a, long long a_elems, const float* b, long long b_elems,
                         float* c, float* probs, void* split, const long long* offs,
                         const long long* strides, int M, int N, int K, int batch, int conj,
                         int do_split, int precision, int nbits, const unsigned* rows,
                         const unsigned* cz, void* stream) {
  tn::GemmArgs p = tn::gemm_args();
  p.a_re = a + offs[0]; p.a_im = a + offs[1];
  p.b_re = b + offs[2]; p.b_im = b + offs[3];
  p.c_re = c + offs[4]; p.c_im = c + offs[5];
  p.a_sb = strides[0]; p.a_sm = strides[1]; p.a_sk = strides[2];
  p.b_sb = strides[3]; p.b_sk = strides[4]; p.b_sn = strides[5];
  p.c_sb = strides[6]; p.c_sm = strides[7]; p.c_sn = 1;
  p.M = M; p.N = N; p.K = K; p.batch = batch;
  p.a_conj = conj & 1 ? -1.f : 1.f;
  p.b_conj = conj & 2 ? -1.f : 1.f;
  tn::PermSpec spec = {};
  if (rows) {
    if (nbits < 1 || nbits > tn::kMaxBits) return cudaErrorInvalidValue;
    p.scatter = 1;
    p.probs = probs;
    spec.nbits = nbits;
    for (int k = 0; k < nbits; ++k) {
      spec.rows[k] = rows[k];
      spec.cz[k] = cz ? cz[k] : 0u;
    }
  }
  auto* sp = static_cast<tn::wg::bf16*>(split);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (precision == tn::kHigh)
    return bf16_product<tn::kHigh>(p, a, a_elems, b, b_elems, sp, do_split, spec, st);
  if (precision == tn::kDefault)
    return bf16_product<tn::kDefault>(p, a, a_elems, b, b_elems, sp, do_split, spec, st);
  return cudaErrorInvalidValue;
}

}  // extern "C"
