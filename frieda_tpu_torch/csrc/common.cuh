// Shared helpers of the port's kernels: u32 M31 arithmetic and the C-ABI
// error convention (every entry point returns cudaGetLastError()).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace frieda {

constexpr uint32_t kP = 0x7FFFFFFFu;  // M31 modulus 2^31 - 1

__device__ __forceinline__ uint32_t umin(uint32_t a, uint32_t b) { return a < b ? a : b; }

// Canonical inputs in [0, P) give canonical outputs in [0, P). Each keeps the
// smaller of the value and the value minus P: below P, the difference wraps
// past 2^31.
__device__ __forceinline__ uint32_t m31_add(uint32_t a, uint32_t b) {
  return umin(a + b, a + b - kP);  // a + b < 2P < 2^32
}

__device__ __forceinline__ uint32_t m31_sub(uint32_t a, uint32_t b) {
  return umin(a - b, a - b + kP);
}

// a * b mod P from b2 = 2b (< 2^32): the 64-bit product a * b2 = 2ab has
// ab >> 31 as its high word and (ab mod 2^31) << 1 as its low word, and
// 2^31 == 1 mod P. a, b < P give hi + (lo >> 1) <= 2P - 3, so one
// conditional subtract ends it.
__device__ __forceinline__ uint32_t m31_mul_dbl(uint32_t a, uint32_t b2) {
  const uint64_t x = static_cast<uint64_t>(a) * b2;
  const uint32_t s = static_cast<uint32_t>(x >> 32) + (static_cast<uint32_t>(x) >> 1);
  return umin(s, s - kP);
}

}  // namespace frieda

#define FRIEDA_LAUNCH_RESULT() return static_cast<int>(cudaGetLastError())
