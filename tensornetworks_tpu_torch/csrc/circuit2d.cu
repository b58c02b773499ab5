// Whole-circuit forward and adjoint backward of the 2D super-block
// statevector, FP32 on planar (re, im) planes, for sm_90a.
//
// Replaces the TPU kernels of tensornetworks_tpu/ops/pallas/circuit2d.py:
//   make_pallas_circuit2d_probs -> kernel / fwd_kernel   (tn_circuit2d_forward)
//   make_pallas_circuit2d_probs -> bwd_kernel            (tn_circuit2d_backward)
//
// The state is the (R, C) = (2^ceil(n/2), 2^floor(n/2)) matrix X (row qubits
// 0..rb-1, column qubits rb..n-1). A layer is, in the TPU kernel's order:
// rotations X <- Mr X Mc^T, row-chain CNOT permutation, boundary CNOT,
// column-chain permutation, ring CNOT, CZ signs. At n=16 one plane pair is
// 512 KB, more than a block's 227 KB of shared memory, so the TPU design of a
// VMEM-resident state does not carry over: each C entry point below is a host
// driver that issues a short sequence of launches on the caller's stream
// (circuit_layers.cuh, shared with circuit2d_grid.cu).
//
// Design: the two rotations are tiled FP32 complex GEMMs (tn_gemm.cuh). All
// CNOTs of a layer are one GF(2)-linear map of the flat index, so the four
// permutation steps (row chain, boundary, column chain, ring) compose into
// one exact index map, and the CZ gates into one sign evaluated at the
// destination. The TPU kernel ran the boundary and ring CNOTs as H.mask.H
// matmuls; the index map computes the same function exactly and with no
// arithmetic. The forward applies it in the epilogue of the right GEMM
// (a scatter), and writes |psi|^2 there on the last layer. The backward
// undoes it with a gather kernel, then pulls the state and the cotangent
// back through the conjugate rotations as one batched GEMM of two, and
// forms the per-layer operator gradients as complex GEMMs.
//
// Bound at n=16, L=4 (R=C=256), as the dense products it performs:
//   forward : 8 L (R^2 C + R C^2) = 1.07 GFLOP FP32, ~4.8 MB moved
//   backward: 24 L (R^2 C + R C^2) = 3.22 GFLOP FP32, ~8.9 MB moved
// Both are bound by FP32 FMA throughput (67 TFLOP/s on the H100 SXM: 16 us
// and 48 us). The GEMM keeps operands in shared memory and accumulators in
// registers; at these sizes a single product has only 64 blocks of 32x32, so
// the first version is bound by occupancy and launch latency, not by the FMA
// units (see PERF.md).

#include "circuit_layers.cuh"

extern "C" {

// probs, xr, xi: (R, C) outputs; tmp: (2, R, C) scratch.
// rows: n masks of the chain map; cz: (layers, n) CZ masks.
int tn_circuit2d_forward(const float* mr_re, const float* mr_im, const float* mc_re,
                         const float* mc_im, float* probs, float* xr, float* xi, float* tmp,
                         int n, int layers, int has_wall, const unsigned* rows,
                         const unsigned* cz, void* stream) {
  const tn::LayerMaps maps = {n, rows, cz, layers};
  return tn::circuit_forward(mr_re, mr_im, mc_re, mc_im, probs, xr, xi, tmp, layers, has_wall,
                             maps, static_cast<cudaStream_t>(stream));
}

// xr, xi, g: (R, C) inputs; dmr_*: (layers, R, R) and dmc_*: (layers, C, C)
// outputs; buf_a, buf_b: (4, R, C) scratch each.
int tn_circuit2d_backward(const float* mr_re, const float* mr_im, const float* mc_re,
                          const float* mc_im, const float* xr, const float* xi,
                          const float* g, float* dmr_re, float* dmr_im, float* dmc_re,
                          float* dmc_im, float* buf_a, float* buf_b, int n, int layers,
                          const unsigned* rows, const unsigned* cz, void* stream) {
  const tn::LayerMaps maps = {n, rows, cz, layers};
  return tn::circuit_backward(mr_re, mr_im, mc_re, mc_im, xr, xi, g, dmr_re, dmr_im, dmc_re,
                              dmc_im, buf_a, buf_b, layers, maps,
                              static_cast<cudaStream_t>(stream));
}

}  // extern "C"
