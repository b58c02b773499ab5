// A circuit layer's CNOTs and CZs as one exact map of the flat state index,
// shared by every circuit kernel of the port: all CNOTs of a layer are one
// GF(2)-linear map of the index, and its CZ gates one sign evaluated at the
// destination.

#pragma once

#include <cuda_runtime.h>

namespace tn {

constexpr int kMaxBits = 32;

// One layer's composite permutation of the flat state index with its sign.
// Bit k below is the LSB-first bit position k of the index.
//   dst(i) bit k = parity(rows[k] & i)            (CNOT chain: GF(2)-linear)
//   sign(d)      = (-1)^(sum_k bit_k(d) * popc(d & cz[k]))   (CZ pairs)
struct PermSpec {
  int nbits;
  unsigned rows[kMaxBits];
  unsigned cz[kMaxBits];
};

__device__ __forceinline__ unsigned perm_dst(const PermSpec& s, unsigned i) {
  unsigned d = 0;
  for (int k = 0; k < s.nbits; ++k) d |= (unsigned)(__popc(s.rows[k] & i) & 1) << k;
  return d;
}

__device__ __forceinline__ float perm_sign(const PermSpec& s, unsigned d) {
  unsigned par = 0;
  for (int k = 0; k < s.nbits; ++k) par ^= ((d >> k) & 1u) & (unsigned)__popc(d & s.cz[k]);
  return (par & 1u) ? -1.f : 1.f;
}

}  // namespace tn
