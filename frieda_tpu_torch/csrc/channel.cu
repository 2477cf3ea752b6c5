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
// grind: for each channel b of a batch of B >= 1 (one channel is B = 1), the
// minimum nonce whose BLAKE2s(digest_b || nonce_le8) has at least pow_bits
// trailing zeros in its first 16 bytes (a u128, little-endian), as
// core/grind.py's sweep and the host's grind_host. Bound: integer issue,
// (nonce_b + 1) compressions a blob. One launch, one body for every B: a
// persistent grid, one wave sized by ops/channel.grind_plan, whose blocks
// claim search items from a counter in device memory. Item i is round
// r = i / B of blob b = i mod B: the W = threads x k nonces [r W, (r + 1) W),
// k to a thread. Items are handed out round-major, so the blobs advance
// through the nonces together and the card's threads are spread over the
// blobs still searching; a blob that is done costs a claim, not its hashes.
// A block
//   - skips an item whose base r W is at or above best[b] when it is claimed
//     (one relaxed load of best[b] an item, not one a nonce);
//   - exits once the base of its claimed round is at or above every blob's
//     best (later claims only have larger bases);
//   - otherwise reads the blob's digest once into registers, and each
//     thread hashes its k nonces in increasing order, stopping at its first
//     hit with atomicMin(best + b, nonce). The compiler hoists what does not
//     depend on the nonce (the parameter IV, 7 of round 0's 8 Gs) out of the
//     k-nonce loop itself: splitting the hash by hand there measured within
//     1-2% (PERF.md section 6, NVIDIA H100 80GB HBM3 at 700 W).
// Why each best[b] ends at blob b's minimum, whatever order the blocks run
// in: best[b] only falls (atomicMin from 2^64 - 1), and holds a qualifying
// nonce once it is below 2^64 - 1. An item is skipped only when its base is
// at or above best[b], so all its nonces are at or above the final best[b];
// a thread stops only at a hit, so the nonces it leaves are larger than a
// qualifying one; a block exits only when every round it could still claim
// lies at or above every best. So every nonce below the final best[b] is
// hashed, and none qualifies. The counter (best[B]) starts at 2^64 - 1 with
// the bests, set by the wrapper's one fill inside whatever CUDA graph holds
// the launch: the first claim wraps to item 0. tests/test_torch_grind_schedule.py
// plays this schedule on the CPU in random claim orders.

#include "blake2s.cuh"
#include "common.cuh"

namespace {

using frieda::blake2s_compress;
using frieda::hash_after;
using frieda::kP;
using frieda::param_iv;

constexpr int kTranscriptThreads = 32;
constexpr int kGrindThreads = 256;
constexpr int kGrindMaxNonces = 64;  // k at most
constexpr int kGrindMaxBlocks = 1 << 16;

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

// One relaxed load from device memory (L2): a best that other blocks lower.
__device__ __forceinline__ unsigned long long load_relaxed(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

struct GrindArgs {
  const uint32_t* state;    // blob b's digest at 9 b
  unsigned long long* best;  // best[b] a blob, then the item counter: all 2^64 - 1 on entry
  int blobs;
  int pow_bits;
  int nonces;               // k: the nonces a thread hashes an item
};

// A persistent grid of kGrindThreads-thread blocks claiming items (see the
// header): thread 0 claims and reads best, the block's barriers hand the item
// to every thread (double-buffered by the claim's parity, so a slow thread's
// read is never overwritten by the next claim).
__global__ void __launch_bounds__(kGrindThreads) grind_kernel(GrindArgs a) {
  __shared__ unsigned long long base_s[2];
  __shared__ int blob_s[2];
  unsigned long long* const counter = a.best + a.blobs;
  const unsigned long long width = static_cast<unsigned long long>(kGrindThreads) * a.nonces;
  for (int turn = 0;; turn ^= 1) {
    bool open = false;
    if (threadIdx.x == 0) {
      const unsigned long long item = atomicAdd(counter, 1ull) + 1ull;  // the first claim wraps to 0
      const unsigned long long round = item / static_cast<unsigned long long>(a.blobs);
      const int blob = static_cast<int>(item - round * static_cast<unsigned long long>(a.blobs));
      blob_s[turn] = blob;
      base_s[turn] = round * width;
      open = round * width < load_relaxed(a.best + blob);
    }
    const bool claimed = __syncthreads_or(open);
    const unsigned long long base = base_s[turn];
    if (!claimed) {
      // skipped: exit once every blob's best is at or below this round's base
      bool left = false;
      for (int b = threadIdx.x; b < a.blobs; b += kGrindThreads) left |= base < load_relaxed(a.best + b);
      if (!__syncthreads_or(left)) return;
      continue;
    }
    const int blob = blob_s[turn];
    const uint32_t* st = a.state + 9 * static_cast<size_t>(blob);
    uint32_t d[8], h[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) d[i] = st[i];
    param_iv(h);
    unsigned long long nonce = base + threadIdx.x;
#pragma unroll 1
    for (int j = 0; j < a.nonces; ++j, nonce += kGrindThreads) {
      const uint32_t m[16] = {d[0], d[1], d[2], d[3], d[4], d[5], d[6], d[7],
                              static_cast<uint32_t>(nonce), static_cast<uint32_t>(nonce >> 32), 0u, 0u, 0u, 0u, 0u, 0u};
      uint32_t w[8];
      blake2s_compress(h, m, 40u, true, w);
      if (trailing_zeros128(w) >= a.pow_bits) {
        atomicMin(a.best + blob, nonce);
        break;
      }
    }
  }
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

// The card's SM count and the grind blocks an SM holds at once (the plan's
// inputs: ops/channel.grind_plan).
extern "C" int frieda_grind_shape(int* sms, int* blocks_per_sm) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, grind_kernel, kGrindThreads, 0);
  }
  return static_cast<int>(err);
}

// state: blobs x 9 words, the channels (each digest is read); best: blobs + 1
// u64, all 2^64 - 1 on entry: blob b's minimum qualifying nonce in best[b] on
// exit, the item counter in best[blobs]. The plan (ops/channel.grind_plan):
// blocks, threads (kGrindThreads) and k nonces a thread an item.
// 0 <= pow_bits <= 128.
extern "C" int frieda_grind(const void* state, int pow_bits, void* best, int blobs, int blocks, int threads,
                            int nonces, void* stream) {
  if (state == nullptr || best == nullptr || pow_bits < 0 || pow_bits > 128 || blobs < 1 || blocks < 1 ||
      blocks > kGrindMaxBlocks || threads != kGrindThreads || nonces < 1 || nonces > kGrindMaxNonces) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const GrindArgs a{static_cast<const uint32_t*>(state), static_cast<unsigned long long*>(best), blobs, pow_bits,
                    nonces};
  grind_kernel<<<blocks, kGrindThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  FRIEDA_LAUNCH_RESULT();
}
