// Threefry-2x32, 20 rounds, on native uint32_t: the port's
// core/prng.py::threefry2x32 and the JAX package's
// minigrid_tpu/core/prng.py::threefry2x32. Shared by the policy kernel
// (its seed stream reads x0), the connect kernel (a jax.random split
// child is the pair (x0, x1), and scalar random bits are x0 ^ x1) and the
// DynamicObstacles walk in step_device.cuh (hash_u31).

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

// core/prng.py::hash_u31: 31 uniform bits per (key, counter), the low 31
// bits of x0 at counter (c, 0). The caller wraps c in uint32, as the
// reference's int32 counter wraps.
__device__ __forceinline__ int hash_u31(uint32_t k0, uint32_t k1, uint32_t c) {
  return static_cast<int>(threefry2x32(k0, k1, c, 0u).x & 0x7FFFFFFFu);
}

}  // namespace
