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
// and `default` the products run on the bf16 tensor cores (three and one
// passes at 989 TFLOP/s): the forward in the units' mma_bf16.cuh passes,
// the backward in the kernel of circuit_bf16.cuh on operands split once.
// At these sizes a single product is 2-3 us of work, so a
// sequence of launches is bound by launch latency and occupancy, not by the
// FMA units (see PERF.md): the reason each direction is one launch.

#include <cmath>

#include "circuit2d_bwd.cuh"
#include "circuit2d_fwd.cuh"
#include "circuit_bf16.cuh"

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
// outputs; scratch: of tn_circuit2d_scratch_bytes (FP32 (4, 4, R, C) under
// kHighest); masks, precision: as the forward's.
// Returns the launch's error: a device that cannot run the cooperative
// launch refuses it, and an unknown precision is refused.
int tn_circuit2d_backward(const float* mr_re, const float* mr_im, const float* mc_re,
                          const float* mc_im, const float* xr, const float* xi,
                          const float* g, float* dmr_re, float* dmr_im, float* dmc_re,
                          float* dmc_im, float* scratch, const unsigned* masks, int n,
                          int layers, int precision, void* stream) {
  if (n < 2 || n > 17 || layers < 1) return (int)cudaErrorInvalidValue;
  const tn::bwd::Args a = {mr_re, mr_im, mc_re, mc_im, xr, xi, g, dmr_re, dmr_im,
                           dmc_re, dmc_im, scratch, masks, n, layers};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  tn::b16::BwdArgs b = {mr_re, mr_im, mc_re, mc_im, xr, xi, g, dmr_re, dmr_im, dmc_re, dmc_im,
                        reinterpret_cast<tn::b16::u16*>(scratch), masks, n, layers};
  switch (precision) {
    case tn::kHighest: return tn::bwd::circuit_backward_persistent(a, st);
    case tn::kHigh: return tn::b16::backward<tn::kHigh>(b, st);
    case tn::kDefault: return tn::b16::backward<tn::kDefault>(b, st);
  }
  return (int)cudaErrorInvalidValue;
}

// Bytes of the scratch a call takes (`tmp` of the forward, `scratch` of the
// backward): FP32 planes, (2, R, C) and, under kHighest, (4, 4, R, C); the
// bf16 split scratch of circuit_bf16.cuh for the backward under kHigh and
// kDefault; -1 for an unknown precision.
long long tn_circuit2d_scratch_bytes(int n, int layers, int backward, int precision) {
  const long long S = 1LL << n;
  if (!backward) return precision >= tn::kHighest && precision <= tn::kDefault ? 8 * S : -1;
  switch (precision) {
    case tn::kHighest: return 4 * 16 * S;
    case tn::kHigh: return 2 * tn::b16::split_elems<tn::kHigh>(n, layers);
    case tn::kDefault: return 2 * tn::b16::split_elems<tn::kDefault>(n, layers);
  }
  return -1;
}

// The launch plan of the backward's bf16 kernel (circuit_bf16.cuh bwd_plan)
// on a card of `sms` SMs, as out[0..5] = cs, items, t0, t1, t2, smem bytes
// (items 0: no plan fits). Returns 0, or -1 for an unknown precision.
int tn_circuit2d_bwd_bf16_plan(int n, int precision, int sms, long long* out) {
  tn::b16::Plan p;
  switch (precision) {
    case tn::kHigh: p = tn::b16::bwd_plan<tn::kHigh>(n, sms); break;
    case tn::kDefault: p = tn::b16::bwd_plan<tn::kDefault>(n, sms); break;
    default: return -1;
  }
  const long long v[6] = {p.cs, p.items, p.t0, p.t1, p.t2, (long long)p.smem};
  for (int i = 0; i < 6; ++i) out[i] = v[i];
  return 0;
}

}  // extern "C"
