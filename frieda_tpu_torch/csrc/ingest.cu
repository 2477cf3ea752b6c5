// Kernel 4, ingest: u32 words -> (4, 2^log_size) bit-reversed coefficients.
//
// Replaces frieda_tpu/ops/ingest_pallas.py: ingest_rows (_ingest_kernel),
// with the per-row bit-reversal that follows it (utils/packing.py:
// bitrev_rows_device) folded in. Output [c, r] is felt f = c*L + rev(r),
// L = 2^log_size, and felt f is bits [30f, 30f + 30) of the little-endian
// word stream (SURVEY.md A.1).
//
// Bound: device-memory bytes, about 16 B read and 4 B written per felt, and
// no arithmetic worth counting.
//
// Design: one thread per output element, in output order, so the writes are
// coalesced; each thread reads the two words holding its felt. Bit offsets
// are 64-bit (30f passes 2^32 once log_size + 2 > 27) and the high word is
// read only when the felt straddles it (s > 2), never past the
// ceil(30 * 4L / 32) + 1 words pad_to_words provides. The TPU version's
// 15-word groups, in-VMEM transpose and two-step bit-reversal exist to avoid
// element-granular gathers on the TPU; here a gather costs a sector read,
// and the reads of one warp span few sectors only for small L.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr uint32_t kMask30 = (1u << 30) - 1u;

__global__ void __launch_bounds__(kThreads)
ingest_kernel(const uint32_t* __restrict__ words, uint32_t* __restrict__ out, int log_size) {
  const uint64_t L = uint64_t(1) << log_size;
  const uint64_t idx = uint64_t(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= 4 * L) return;
  const uint64_t c = idx >> log_size;
  const uint32_t r = static_cast<uint32_t>(idx & (L - 1));
  const uint32_t rev = log_size ? (__brev(r) >> (32 - log_size)) : 0u;
  const uint64_t bit = 30 * (c * L + rev);
  const uint64_t w = bit >> 5;
  const uint32_t s = static_cast<uint32_t>(bit & 31);
  uint32_t v = words[w] >> s;
  if (s > 2) v |= words[w + 1] << (32 - s);
  out[idx] = v & kMask30;
}

}  // namespace

// words: >= ceil(30 * 2^(log_size + 2) / 32) + 1 u32; out: (4, 2^log_size) u32.
extern "C" int frieda_ingest(const void* words, void* out, int log_size, void* stream) {
  const uint64_t total = uint64_t(4) << log_size;
  const dim3 grid(static_cast<unsigned>((total + kThreads - 1) / kThreads));
  ingest_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), static_cast<uint32_t*>(out), log_size);
  FRIEDA_LAUNCH_RESULT();
}

// Message of a code returned by any frieda_* entry point.
extern "C" const char* frieda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
