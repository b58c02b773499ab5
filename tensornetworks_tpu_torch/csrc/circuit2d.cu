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
// column-chain permutation, ring CNOT, CZ signs (bn_structured: the DAG
// edges' CNOTs on even layers, their CZs on odd ones). At n=16 one plane pair is
// 512 KB, more than a block's 227 KB of shared memory, so the TPU design of a
// VMEM-resident state does not carry over: the state lives in L2.
//
// Design: the two rotations are tiled FP32 complex GEMMs. All CNOTs of a
// layer are one GF(2)-linear map of the flat index, so the four permutation
// steps (row chain, boundary, column chain, ring) compose into one exact
// index map, and the CZ gates into one sign evaluated at the destination.
// The TPU kernel ran the boundary and ring CNOTs as H.mask.H matmuls; the
// index map computes the same function exactly and with no arithmetic.
// Both directions are one persistent cooperative kernel each (one block per
// SM, phases separated by grid-wide barriers, the work units of
// circuit_units.cuh):
// - the forward (circuit2d_fwd.cuh) computes Mr[0] X0 in closed form, then
//   per layer the right product whose store scatters through the map (and
//   writes |psi|^2 on the last layer), and the next layer's left product;
// - the backward (circuit2d_bwd.cuh) undoes the map on the state and the
//   cotangent, pulls both back through the conjugate rotations and forms the
//   per-layer operator gradients.
//
// Bound at n=16, L=4 (R=C=256), as the dense products it performs:
//   forward : 8 L (R^2 C + R C^2) = 1.07 GFLOP FP32, ~4.8 MB moved
//   backward: 24 L (R^2 C + R C^2) = 3.22 GFLOP FP32, ~8.9 MB moved
// Both are bound by FP32 FMA throughput (67 TFLOP/s on the H100 SXM: 16 us
// and 48 us) at the default precision; under the kernel precision `high`
// and `default` the products run on the bf16 tensor cores (mma_bf16.cuh:
// three and one passes at 989 TFLOP/s). At these sizes a single product is 2-3 us of work, so a
// sequence of launches is bound by launch latency and occupancy, not by the
// FMA units (see PERF.md): the reason each direction is one launch.

#include <cmath>

#include "circuit2d_bwd.cuh"
#include "circuit2d_fwd.cuh"

extern "C" {

// probs, xr, xi: (R, C) outputs; tmp: (2, R, C) scratch; masks: (2 layers,
// n) on the device, layer l's row masks at row 2l and its CZ masks at row
// 2l + 1; precision: a tn::Precision code. Returns the launch's error: a
// device that cannot run the cooperative launch refuses it, and an unknown
// precision is refused.
int tn_circuit2d_forward(const float* mr_re, const float* mr_im, const float* mc_re,
                         const float* mc_im, float* probs, float* xr, float* xi, float* tmp,
                         const unsigned* masks, int n, int layers, int has_wall, int precision,
                         void* stream) {
  if (n < 2 || n > 17 || layers < 1) return (int)cudaErrorInvalidValue;
  const tn::fwd::Args a = {mr_re, mr_im, mc_re, mc_im, probs, xr, xi, tmp, masks,
                           n, layers, has_wall, (float)std::pow(2.0, -0.5 * n)};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (precision) {
    case tn::kHighest: return tn::fwd::circuit_forward_persistent<tn::kHighest>(a, st);
    case tn::kHigh: return tn::fwd::circuit_forward_persistent<tn::kHigh>(a, st);
    case tn::kDefault: return tn::fwd::circuit_forward_persistent<tn::kDefault>(a, st);
  }
  return (int)cudaErrorInvalidValue;
}

// xr, xi, g: (R, C) inputs; dmr_*: (layers, R, R) and dmc_*: (layers, C, C)
// outputs; scratch: (4, 4, R, C); masks, precision: as the forward's.
// Returns the launch's error: a device that cannot run the cooperative
// launch refuses it, and an unknown precision is refused.
int tn_circuit2d_backward(const float* mr_re, const float* mr_im, const float* mc_re,
                          const float* mc_im, const float* xr, const float* xi,
                          const float* g, float* dmr_re, float* dmr_im, float* dmc_re,
                          float* dmc_im, float* scratch, const unsigned* masks, int n,
                          int layers, int precision, void* stream) {
  const tn::bwd::Args a = {mr_re, mr_im, mc_re, mc_im, xr, xi, g, dmr_re, dmr_im,
                           dmc_re, dmc_im, scratch, masks, n, layers};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (precision) {
    case tn::kHighest: return tn::bwd::circuit_backward_persistent<tn::kHighest>(a, st);
    case tn::kHigh: return tn::bwd::circuit_backward_persistent<tn::kHigh>(a, st);
    case tn::kDefault: return tn::bwd::circuit_backward_persistent<tn::kDefault>(a, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
