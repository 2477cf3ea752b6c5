// Kernels 7 and 8, transcript and grind: the Fiat-Shamir channel on the card.
//
// Replace the JAX package's device channel, frieda_tpu/core/device_channel.py:
// dc_mix_u64, dc_mix_digest, dc_mix_felts, dc_draw_felt (dc_draw_base_felts)
// and dc_sample_query_words (transcript), dc_grind (grind). XLA runs those
// inside the FRI commit phase's one jitted dispatch
// (frieda_tpu/core/fri.py:_fri_commit_fn); they have no Pallas kernel. Here
// they are kernels because two of them loop on data: the whole-draw retry of
// draw_felt and the nonce search of the grind. Plain PyTorch could run those
// loops only with a host synchronization a trip.
//
// The channel's hash is RFC BLAKE2s-256 (parameter block in h, byte counter,
// final flag: blake2s.cuh blake2s_compress, hash_after, draw_felt), not the
// Merkle kernels' zero-state compression. The state is 9 u32 words in device
// memory: the digest (8 words, little-endian) and n_sent. Every mix replaces
// the digest with BLAKE2s(digest || payload) and resets n_sent; a draw
// hashes digest || n_sent (8 bytes LE) and counts n_sent up.
//
// Where each step of a proof runs: the seed mix and every layer's root mix
// and alpha draw run in the merkle_collapse launch that ends the layer's
// tree (merkle.cu, its channel step), so a layer adds no launch to the
// commit phase's chain. A transcript launch runs the rest: the last-layer
// felts, the nonce mix with the query draws, and the step of a tree that
// ends without a collapse (8 leaves or fewer; a mesh of one shard).
//
// transcript: one block of one warp runs the steps a launch asks for, in
// this order: mix_u64 (a constant, or two words in device memory: the
// grind's nonce), mix_digest (a Merkle root read from its tree), mix_felts
// (k QM31 from device memory, ceil((32 + 16k) / 64) blocks), draw_felt
// (retry while any of the 8 words >= draw_bound; the 4 reduced words are
// written where the next fri_fold reads alpha), then the query draws. Bound:
// latency, a chain of dependent compressions on lane 0 (one a mix of <= 64
// bytes, one a draw attempt); the query draws are independent (n_sent
// differs) and take one lane each.
//
// Blob axis (the batched commit phase, the counterpart of jax.vmap over the
// dc_* steps): a launch takes B channels, (B, 9) states, each blob with its
// own payloads at fixed strides (its 2 nonce words, 8 root words, k x 4 felt
// words; its 4 alpha words and n_queries query words out); transcript runs
// one block a blob, each the chain above.
//
// grind: the minimum nonce whose BLAKE2s(digest || nonce_le8) has at least
// pow_bits trailing zeros in its first 16 bytes (a u128, little-endian), as
// core/grind.py's sweep and the host's grind_host. Bound: integer issue,
// (nonce + 1) compressions of one block. Design: one launch, the search loop
// on the card. A grid that fits on the card at once walks the 64-bit nonces
// grid-stride; a thread stops at its first qualifying nonce (atomicMin into
// best) or at its first nonce not below the current best. best only falls,
// so every nonce a thread skips lies above the final minimum, and every
// nonce below it was hashed: the result is the minimum, whatever the order
// in which threads run. The caller sets best to 2^64 - 1 first.
//
// A batch of B channels shares the grid: a thread takes the nonces of its
// grid-stride walk for every blob in turn, each blob with its own best
// (atomicMin) and its own early exit (a nonce not below that blob's best is
// skipped), and stops when its nonce is at or above every blob's best. Each
// blob's best is then its own minimum by the argument above, and a blob
// that is done leaves the whole grid to the others.

#include "blake2s.cuh"
#include "common.cuh"

namespace {

using frieda::blake2s_compress;
using frieda::hash_after;
using frieda::kP;
using frieda::param_iv;

constexpr int kTranscriptThreads = 32;
constexpr int kGrindThreads = 256;

struct TranscriptArgs {
  uint32_t* state;          // digest (8 words), n_sent; blob b's at 9 b
  int mix_u64;              // mix a u64: from u64_src (lo, hi) when set, else u64_value
  unsigned long long u64_value;
  const uint32_t* u64_src;  // 2 words a blob
  const uint32_t* root;     // mix_digest: 8 words a blob, or null
  const uint32_t* felts;    // mix_felts: n_felts x 4 words a blob, or null
  int n_felts;
  uint32_t* alpha;          // draw_felt: 4 words out a blob, or null
  uint32_t draw_bound;      // retry while any drawn word >= draw_bound (2P)
  uint32_t* queries;        // n_queries raw query words out a blob, or null
  int n_queries;
  uint32_t query_mask;      // 2^log_domain - 1
};

__global__ void __launch_bounds__(kTranscriptThreads) transcript_kernel(TranscriptArgs a) {
  __shared__ uint32_t digest_s[8];
  __shared__ uint32_t n_sent_s;
  const size_t blob = blockIdx.x;  // one block a channel
  uint32_t* state = a.state + 9 * blob;
  if (threadIdx.x == 0) {
    uint32_t d[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) d[i] = state[i];
    uint32_t n_sent = state[8];
    if (a.mix_u64) {
      uint32_t v[2];
      if (a.u64_src != nullptr) {
        v[0] = a.u64_src[2 * blob];
        v[1] = a.u64_src[2 * blob + 1];
      } else {
        v[0] = static_cast<uint32_t>(a.u64_value);
        v[1] = static_cast<uint32_t>(a.u64_value >> 32);
      }
      hash_after(d, v, 2, d);
      n_sent = 0;
    }
    if (a.root != nullptr) {
      hash_after(d, a.root + 8 * blob, 8, d);
      n_sent = 0;
    }
    if (a.felts != nullptr) {
      hash_after(d, a.felts + size_t(4) * a.n_felts * blob, 4 * a.n_felts, d);
      n_sent = 0;
    }
    if (a.alpha != nullptr) frieda::draw_felt(d, n_sent, a.draw_bound, a.alpha + 4 * blob);
#pragma unroll
    for (int i = 0; i < 8; ++i) digest_s[i] = d[i];
    n_sent_s = n_sent;
  }
  __syncthreads();
  const uint32_t draws = a.queries != nullptr ? (static_cast<uint32_t>(a.n_queries) + 7u) / 8u : 0u;
  if (draws) {
    uint32_t* queries = a.queries + size_t(a.n_queries) * blob;
    uint32_t d[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) d[i] = digest_s[i];
    for (uint32_t k = threadIdx.x; k < draws; k += kTranscriptThreads) {
      const uint32_t v[2] = {n_sent_s + k, 0u};
      uint32_t w[8];
      hash_after(d, v, 2, w);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const uint32_t q = 8u * k + i;
        if (q < static_cast<uint32_t>(a.n_queries)) queries[q] = w[i] & a.query_mask;
      }
    }
  }
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < 8; ++i) state[i] = digest_s[i];
    state[8] = n_sent_s + draws;
  }
}

// Trailing zeros of the u128 little-endian w[0..3] (128 when all are zero).
__device__ __forceinline__ int trailing_zeros128(const uint32_t (&w)[8]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (w[i]) return 32 * i + __ffs(static_cast<int>(w[i])) - 1;
  }
  return 128;
}

// Whether nonce clears pow_bits on digest d: BLAKE2s(d || nonce_le8) with at
// least pow_bits trailing zeros in its first 16 bytes.
__device__ __forceinline__ bool clears(const uint32_t (&d)[8], unsigned long long nonce, int pow_bits) {
  const uint32_t m[16] = {d[0], d[1], d[2], d[3], d[4], d[5], d[6], d[7],
                          static_cast<uint32_t>(nonce), static_cast<uint32_t>(nonce >> 32),
                          0u, 0u, 0u, 0u, 0u, 0u};
  uint32_t h[8], out[8];
  param_iv(h);
  blake2s_compress(h, m, 40u, true, out);
  return trailing_zeros128(out) >= pow_bits;
}

// ONE: one channel, its digest in registers for the whole search and the
// thread gone at its first qualifying nonce. A batch's form (a loop over the
// blobs inside the nonce loop, each digest read a nonce) took ~9% longer for
// one channel (0.263-0.273 against 0.242-0.250 ms in a 2^20 and a 2^24
// proof's graph replay, NVIDIA H100 80GB HBM3 at 700 W, PERF.md section 6),
// so one channel keeps this form.
template <bool ONE>
__global__ void __launch_bounds__(kGrindThreads)
grind_kernel(const uint32_t* __restrict__ state, int pow_bits, unsigned long long* best, int blobs) {
  volatile unsigned long long* const seen = best;
  const unsigned long long stride = static_cast<unsigned long long>(gridDim.x) * kGrindThreads;
  const unsigned long long first = static_cast<unsigned long long>(blockIdx.x) * kGrindThreads + threadIdx.x;
  if constexpr (ONE) {
    uint32_t d[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) d[i] = state[i];
    for (unsigned long long nonce = first;; nonce += stride) {
      if (nonce >= *seen) return;
      if (clears(d, nonce, pow_bits)) {
        atomicMin(best, nonce);
        return;
      }
    }
  } else {
    for (unsigned long long nonce = first;; nonce += stride) {
      bool open = false;  // some blob's best is still above this nonce
      for (int b = 0; b < blobs; ++b) {
        if (nonce >= seen[b]) continue;
        open = true;
        uint32_t d[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) d[i] = state[9 * b + i];
        if (clears(d, nonce, pow_bits)) atomicMin(best + b, nonce);
      }
      if (!open) return;
    }
  }
}

// Blocks of a grind form's grid: as many as the card holds at once.
template <bool ONE>
cudaError_t grind_blocks(int* blocks) {
  static int cached = 0;
  static cudaError_t err = cudaSuccess;
  if (cached == 0 && err == cudaSuccess) {
    int device = 0, sms = 0, per_sm = 0;
    err = cudaGetDevice(&device);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, grind_kernel<ONE>, kGrindThreads, 0);
    }
    if (err == cudaSuccess) cached = sms * (per_sm > 0 ? per_sm : 1);
  }
  *blocks = cached;
  return err;
}

}  // namespace

// state: blobs x 9 u32 words (digest, n_sent), updated in place. Null
// pointers skip their step; u64_src (2 words a blob) overrides u64_value.
// The caller checks the operands' shapes, n_felts >= 1 with felts,
// 1 <= draw_bound <= 2P and 0 <= log_domain <= 32.
extern "C" int frieda_transcript(void* state, int mix_u64, unsigned long long u64_value,
                                 const void* u64_src, const void* root, const void* felts,
                                 int n_felts, void* alpha, unsigned int draw_bound, void* queries,
                                 int n_queries, int log_domain, int blobs, void* stream) {
  if (state == nullptr || (felts != nullptr && n_felts < 1) || draw_bound == 0 ||
      draw_bound > 2u * kP || n_queries < 0 || log_domain < 0 || log_domain > 32 || blobs < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  TranscriptArgs a{static_cast<uint32_t*>(state), mix_u64, u64_value,
                   static_cast<const uint32_t*>(u64_src), static_cast<const uint32_t*>(root),
                   static_cast<const uint32_t*>(felts), n_felts, static_cast<uint32_t*>(alpha),
                   draw_bound, static_cast<uint32_t*>(queries), n_queries,
                   log_domain == 32 ? 0xFFFFFFFFu : (1u << log_domain) - 1u};
  transcript_kernel<<<blobs, kTranscriptThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  FRIEDA_LAUNCH_RESULT();
}

// Blocks of the grind's grid (one channel's form): as many as the card holds
// at once.
extern "C" int frieda_grind_blocks(int* blocks) { return static_cast<int>(grind_blocks<true>(blocks)); }

// state: blobs x 9 words, the channels (each digest is read); best: one u64
// a blob, 2^64 - 1 on entry, the blob's minimum qualifying nonce on exit.
// 0 <= pow_bits <= 128.
extern "C" int frieda_grind(const void* state, int pow_bits, void* best, int blobs, void* stream) {
  if (pow_bits < 0 || pow_bits > 128 || blobs < 1) return static_cast<int>(cudaErrorInvalidValue);
  int blocks = 0;
  const cudaError_t err = blobs == 1 ? grind_blocks<true>(&blocks) : grind_blocks<false>(&blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* st = static_cast<const uint32_t*>(state);
  unsigned long long* b = static_cast<unsigned long long*>(best);
  if (blobs == 1) {
    grind_kernel<true><<<blocks, kGrindThreads, 0, s>>>(st, pow_bits, b, 1);
  } else {
    grind_kernel<false><<<blocks, kGrindThreads, 0, s>>>(st, pow_bits, b, blobs);
  }
  FRIEDA_LAUNCH_RESULT();
}
