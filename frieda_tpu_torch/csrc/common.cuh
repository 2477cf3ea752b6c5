// Shared helpers of the port's kernels: u32 M31 arithmetic and the C-ABI
// error convention (every entry point returns cudaGetLastError()).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace frieda {

constexpr uint32_t kP = 0x7FFFFFFFu;  // M31 modulus 2^31 - 1

// Canonical inputs in [0, P) give canonical outputs in [0, P).
__device__ __forceinline__ uint32_t m31_add(uint32_t a, uint32_t b) {
  const uint32_t s = a + b;  // < 2P < 2^32
  return s >= kP ? s - kP : s;
}

__device__ __forceinline__ uint32_t m31_sub(uint32_t a, uint32_t b) {
  const uint32_t s = a + (kP - b);  // in (0, 2P]
  return s >= kP ? s - kP : s;
}

// 64-bit product, Mersenne folds (2^31 == 1 mod P), one conditional subtract.
__device__ __forceinline__ uint32_t m31_mul(uint32_t a, uint32_t b) {
  const uint64_t x = static_cast<uint64_t>(a) * b;  // < 2^62
  uint32_t s = static_cast<uint32_t>(x & kP) + static_cast<uint32_t>(x >> 31);  // < 2^32
  s = (s & kP) + (s >> 31);  // <= P
  return s >= kP ? s - kP : s;
}

}  // namespace frieda

#define FRIEDA_LAUNCH_RESULT() return static_cast<int>(cudaGetLastError())
