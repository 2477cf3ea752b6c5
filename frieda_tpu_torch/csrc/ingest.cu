// Kernel 4, ingest: u32 words -> (4, 2^log_size) bit-reversed coefficients.
//
// Replaces frieda_tpu/ops/ingest_pallas.py: ingest_rows (_ingest_kernel),
// with the per-row bit-reversal that follows it (utils/packing.py:
// bitrev_rows_device) folded in. Output [c, r] is felt f = c*L + rev(r),
// L = 2^log_size, and felt f is bits [30f, 30f + 30) of the little-endian
// word stream (SURVEY.md A.1).
//
// Bound: device-memory bytes, 3.75 B read and 4 B written per felt, and no
// arithmetic worth counting.
//
// Design: a bit-reversal tile through shared memory (log_size >= 10). With
// r = hi * 2^(ls-5) + mid * 2^5 + lo (hi, lo < 32), rev(r) = rev5(lo) *
// 2^(ls-5) + rev(mid) * 2^5 + rev5(hi). For one (c, mid, lo) the 32 values
// of hi read the felts base + 0..31, base a multiple of 32: one 30-word run
// (960 bits), word-aligned; for one hi the 32 values of lo write 32
// contiguous outputs. A block takes P tiles whose rev(mid) are consecutive
// (P = ops/ingest.py:ingest_tile(log_size): 8 from log_size 13 on), so for
// each lo its P runs are one span of 30P words: at P = 8, 960 bytes, 32-byte
// aligned, every sector read by one block, whole. The block reads its 32
// spans with coalesced loads into runs padded to 31 words (odd, so the
// unpack's 32 lanes, one run each, hit 32 banks), then each warp takes one
// output row (one tile, one hi): lane lo unpacks felt rev5(hi) of run lo
// (a field may straddle two words; the high word is read only when s > 2)
// and writes it, 128 contiguous bytes a warp. Every word is read once and
// every output written once. Below a full tile (log_size < 10) the
// per-element form runs instead, chosen by shape alone: one thread per
// output in output order, reading the one or two words of its felt. Bit
// offsets there are 64-bit (30f passes 2^32 once log_size + 2 > 27), and no
// word past the ceil(30 * 4L / 32) + 1 that pad_to_words provides is read.
//
// Blob axis (commit_many): a batch is pad_to_words rows stacked, `row_words`
// apart. A row is 30 * 2^(ls - 3) + 1 words, so the batch is not one blob of
// 4B columns: every block works out its blob's row base. Blob b is grid row
// blockIdx.y + i * gridDim.y (at most 65535 grid rows, so a block may take
// more than one blob); row and output bases are 64-bit (B * 4 * 2^ls passes
// 2^31 at 128 blobs of 2^24 felts). The 2-D call is one blob.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr uint32_t kMask30 = (1u << 30) - 1u;
constexpr uint32_t kRunWords = 30;   // 32 felts of 30 bits
constexpr uint32_t kRunStride = 31;  // a run's words in shared memory, padded

__device__ __forceinline__ uint32_t rev5(uint32_t x) { return __brev(x) >> 27; }

// Felt k (< 32) of a run of 30 words.
__device__ __forceinline__ uint32_t unpack(const uint32_t* run, uint32_t k) {
  const uint32_t bit = 30 * k, s = bit & 31;
  uint32_t v = run[bit >> 5] >> s;
  if (s > 2) v |= run[(bit >> 5) + 1] << (32 - s);
  return v & kMask30;
}

template <uint32_t P>
__global__ void __launch_bounds__(kThreads)
ingest_tile_kernel(const uint32_t* __restrict__ words, uint32_t* __restrict__ out, int log_size,
                   size_t row_words, uint32_t blobs) {
  __shared__ uint32_t runs[P * 32 * kRunStride];  // run (pp, lo) at runs[(pp * 32 + lo) * 31]
  const int mid_bits = log_size - 10;
  const uint32_t per_column = (1u << mid_bits) / P;  // blocks a column
  const uint32_t c = blockIdx.x / per_column;
  const uint32_t p0 = (blockIdx.x % per_column) * P;  // rev(mid) of the block's first tile
  const size_t column = size_t(c) << log_size;
  for (uint32_t b = blockIdx.y; b < blobs; b += gridDim.y) {
    const uint32_t* __restrict__ row = words + b * row_words;
    uint32_t* __restrict__ blob = out + (size_t(b) << (log_size + 2));
    if (b != blockIdx.y) __syncthreads();  // the last blob's unpack has read its runs
#pragma unroll 4
    for (uint32_t i = threadIdx.x; i < 32 * kRunWords * P; i += kThreads) {
      const uint32_t lo = i / (kRunWords * P), at = i % (kRunWords * P);
      const size_t felt0 = column + (size_t(rev5(lo)) << (log_size - 5)) + size_t(p0) * 32;
      runs[((at / kRunWords) * 32 + lo) * kRunStride + at % kRunWords] =
          row[felt0 / 32 * kRunWords + at];
    }
    __syncthreads();
    const uint32_t lo = threadIdx.x & 31;
    for (uint32_t q = threadIdx.x / 32; q < 32 * P; q += kThreads / 32) {  // row (pp, hi)
      const uint32_t pp = q / 32, hi = q % 32;
      const uint32_t mid = mid_bits ? __brev(p0 + pp) >> (32 - mid_bits) : 0u;
      blob[column + (size_t(hi) << (log_size - 5)) + mid * 32 + lo] =
          unpack(&runs[(pp * 32 + lo) * kRunStride], rev5(hi));
    }
  }
}

__global__ void __launch_bounds__(kThreads)
ingest_element_kernel(const uint32_t* __restrict__ words, uint32_t* __restrict__ out, int log_size,
                      size_t row_words, uint32_t blobs) {
  const uint64_t L = uint64_t(1) << log_size;
  const uint64_t idx = uint64_t(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= 4 * L) return;
  const uint64_t c = idx >> log_size;
  const uint32_t r = static_cast<uint32_t>(idx & (L - 1));
  const uint32_t rev = log_size ? (__brev(r) >> (32 - log_size)) : 0u;
  const uint64_t bit = 30 * (c * L + rev);
  const uint64_t w = bit >> 5;
  const uint32_t s = static_cast<uint32_t>(bit & 31);
  for (uint32_t b = blockIdx.y; b < blobs; b += gridDim.y) {
    const uint32_t* __restrict__ row = words + b * row_words;
    uint32_t v = row[w] >> s;
    if (s > 2) v |= row[w + 1] << (32 - s);
    out[uint64_t(b) * 4 * L + idx] = v & kMask30;
  }
}

constexpr unsigned kGridRowsMax = 65535;  // gridDim.y's limit

template <uint32_t P>
int launch_tile(const uint32_t* words, uint32_t* out, int log_size, size_t row_words,
                uint32_t blobs, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((uint64_t(4) << (log_size - 10)) / P),
                  blobs < kGridRowsMax ? blobs : kGridRowsMax);
  ingest_tile_kernel<P><<<grid, kThreads, 0, stream>>>(words, out, log_size, row_words, blobs);
  FRIEDA_LAUNCH_RESULT();
}

}  // namespace

// words: `blobs` rows of row_words u32, each >= ceil(30 * 2^(log_size + 2)
// / 32) + 1 words; out: (blobs, 4, 2^log_size) u32. tile: tiles a block (1,
// 2, 4 or 8, at most 2^(log_size - 10)), or 0 for the per-element form.
extern "C" int frieda_ingest(const void* words, void* out, int log_size, int tile,
                             long long row_words, int blobs, void* stream) {
  const auto* w = static_cast<const uint32_t*>(words);
  auto* o = static_cast<uint32_t*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (log_size < 0 || log_size > 30 || blobs < 1 ||
      row_words < (30 * (4ll << log_size) + 31) / 32 + 1 ||
      (tile && (log_size < 10 || tile > (1 << (log_size - 10))))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t rw = static_cast<size_t>(row_words);
  const uint32_t nb = static_cast<uint32_t>(blobs);
  switch (tile) {
    case 0: {
      const uint64_t total = uint64_t(4) << log_size;
      const dim3 grid(static_cast<unsigned>((total + kThreads - 1) / kThreads),
                      nb < kGridRowsMax ? nb : kGridRowsMax);
      ingest_element_kernel<<<grid, kThreads, 0, s>>>(w, o, log_size, rw, nb);
      FRIEDA_LAUNCH_RESULT();
    }
    case 1: return launch_tile<1>(w, o, log_size, rw, nb, s);
    case 2: return launch_tile<2>(w, o, log_size, rw, nb, s);
    case 4: return launch_tile<4>(w, o, log_size, rw, nb, s);
    case 8: return launch_tile<8>(w, o, log_size, rw, nb, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Message of a code returned by any frieda_* entry point.
extern "C" const char* frieda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
