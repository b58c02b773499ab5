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
// tensor cores instead (tn_gemm.cuh, mma_bf16.cuh): 3 and 1 passes, bound
// at 989 TFLOP/s by 3x and 1x the dense products' operations. From n=19 every non-scatter product
// has at least 128 tiles of 128x64 and takes tn_gemm.cuh's large loop
// (cp.async pipeline, 8x4 complex register tiles); from n=20 the forward's
// right product does too, with the scatter epilogue (the CNOT map split as
// dst(m*N) ^ dst(n), the sign per element, scalar stores into the
// L2-resident state). The forward first transposes Mc into a scratch the
// wrapper passes (64 MB moved at n=20), so that the right product's B is
// n-contiguous and streams by cp.async like the left product's. The n=18
// products and the n=19 scatter product (32 and 64 tiles) keep the 64x64 or
// 32x32 configuration of the first loop.

#include "circuit_layers.cuh"

extern "C" {

// (P_row Mr): (layers, R, R) planes; Mc: (layers, C, C) planes.
// probs, xr, xi: (R, C) outputs; tmp: (2, R, C) and mct: (2, layers, C, C)
// scratch.
// rows: (layers, n) masks of each layer's index map (HE: the boundary /
// column-chain / ring map on every layer); cz: (layers, n) CZ masks of each
// layer. Both are host tables. precision: a tn::Precision code.
int tn_circuit2d_grid_forward(const float* mr_re, const float* mr_im, const float* mc_re,
                              const float* mc_im, float* probs, float* xr, float* xi,
                              float* tmp, float* mct, int n, int layers, int has_wall,
                              int precision, const unsigned* rows, const unsigned* cz,
                              void* stream) {
  const tn::LayerMaps maps = {n, rows, cz};
  return tn::circuit_forward(mr_re, mr_im, mc_re, mc_im, probs, xr, xi, tmp, mct, layers,
                             has_wall, maps, precision, static_cast<cudaStream_t>(stream));
}

// xr, xi, g: (R, C) inputs; dmr_*: (layers, R, R) and dmc_*: (layers, C, C)
// outputs (gradients of the P_row-folded operators); buf_a, buf_b: (4, R, C)
// scratch each; precision, rows, cz: as the forward's.
int tn_circuit2d_grid_backward(const float* mr_re, const float* mr_im, const float* mc_re,
                               const float* mc_im, const float* xr, const float* xi,
                               const float* g, float* dmr_re, float* dmr_im, float* dmc_re,
                               float* dmc_im, float* buf_a, float* buf_b, int n, int layers,
                               int precision, const unsigned* rows, const unsigned* cz,
                               void* stream) {
  const tn::LayerMaps maps = {n, rows, cz};
  return tn::circuit_backward(mr_re, mr_im, mc_re, mc_im, xr, xi, g, dmr_re, dmr_im, dmc_re,
                              dmc_im, buf_a, buf_b, layers, maps, precision,
                              static_cast<cudaStream_t>(stream));
}

}  // extern "C"
