// Threefry-2x32, 20 rounds, on native uint32_t: the port's
// core/prng.py::threefry2x32 and the JAX package's
// minigrid_tpu/core/prng.py::threefry2x32. Shared by the policy kernel
// (its seed stream reads x0) and the connect kernel (a jax.random split
// child is the pair (x0, x1), and scalar random bits are x0 ^ x1).

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) { return (x << r) | (x >> (32 - r)); }

// (x0, x1) of Threefry-2x32 under key (k0, k1) at counter (x0, x1).
__device__ __forceinline__ uint2 threefry2x32(uint32_t k0, uint32_t k1, uint32_t x0, uint32_t x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl32(x1, rot[i % 2][j]);
      x1 ^= x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + static_cast<uint32_t>(i + 1);
  }
  return make_uint2(x0, x1);
}

}  // namespace
