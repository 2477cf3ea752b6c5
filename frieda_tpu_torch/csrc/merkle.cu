// The Merkle kernels, over BLAKE2s zero-state compressions: tree levels
// (merkle_level, merkle_collapse) and the decommitment's reads (merkle_open).
//
// merkle_level replaces frieda_tpu/ops/merkle_pallas.py: leaf_level
// (_leaf_kernel), inner_level (_inner_kernel), leaf3_level (_leaf3_kernel,
// _combine3) and inner3_level (_inner3_kernel). merkle_collapse replaces
// collapse_level / collapse_multi (_collapse_kernel_factory): every requested
// output width of the narrow tail in one launch.
//
// Bound: integer ALU work. A compression is ~1,000 integer instructions
// (chip_smoke.py counts them in frieda_blake2s_probe) for 32-64 bytes in and
// 32 bytes out, so the leaf and inner levels are limited
// by the SMs' integer throughput, not by device memory. The collapse has too
// little work for that: it is bound by its chain of log2(m) dependent
// compressions, one per level.
//
// Design, merkle_level: one thread per output node, the whole compression in
// registers, every 16-word message indexed with constants. Pairing is by
// natural halves: level M pairs node j with node j + M/2, so the fused form
// (three pairing levels per pass) reads the eight eighth-offset positions
// j + t*M/8 and the two intermediate levels never reach device memory. The
// 15 compressions of a fused leaf node run depth first (l1_0 = H(l0_0, l0_4),
// l1_2, then l2_0; l1_1, l1_3, then l2_1; then the root), so at most four
// child hashes are live at once. Word w of node x sits at level[w * M + x]:
// neighbouring threads read neighbouring words.
//
// Design, merkle_collapse: one thread-block cluster of B blocks (B from
// ops/merkle.py:collapse_plan, a pure function of m: B = 1, 2, ..., 16) takes
// a level of width m <= 4096 down the tree. Level width w pairs node x with
// x + w/2, so the nodes x = b (mod B) form a subtree down to width B with no
// exchange: block b reads its m/B nodes x = b + B*i (strided reads of a level
// that the previous launch left in L2), pairs them into its own shared memory
// on the first level, halves them in place down to one node, node b of the
// width-B level, and stores that node into rank 0's shared memory through
// distributed shared memory. After the cluster barrier, rank 0 ends the tree
// from width B. A block has m/B/2 threads (at least one warp): one per
// compression of its first level, so at 128 threads each scheduler of the SM
// runs one warp, and the four independent G functions of a BLAKE2s
// half-round are what hides the latency of the next. The requested widths
// (descending powers of two dividing m, at most kMaxOuts; the prover's pruned
// trees ask for m/8, m/64, ..., 1, the commit for 1) are written by the
// blocks that own their nodes when w >= B, by rank 0 below B. Inside a block,
// thread x reads nodes x and x + half and writes node x, so no node is
// written while another thread reads it; a barrier separates levels, and
// another keeps a level from being overwritten while it is copied out. With
// B = 1 the same kernel runs as one block and no cluster barrier is reached.
// The non-portable cluster size 16 is opted into once per process. The TPU
// version keeps up to 8 x 32768 nodes (1 MiB) in VMEM; here merkle_level
// keeps fusing down to width 4096 first.
//
// The channel step (the prover's trees): a collapse of one blob that ends
// the tree at the root may carry the Fiat-Shamir step of the layer whose
// tree it ends, so that the step adds no launch to the commit phase's serial
// chain. Thread 0 of the block that holds the root in shared memory (rank 0
// after the cluster's finish, or the one block of B = 1) runs, after the
// barrier that made the root visible, transcript_kernel's lane-0 code for
// those steps (channel.cu, with blake2s.cuh's hash_after and draw_felt):
// mix the seed if given (layer 0), mix the root, draw alpha with the retry
// while any word >= draw_bound, then write alpha (where the layer's fri_fold
// reads it) and the 9 state words. It adds a chain of 2 (3 with the seed)
// dependent channel compressions, ~1 us each, to the end of the launch and
// changes nothing before it. The last-layer felts and the nonce and query
// draws stay transcript launches: they follow plain PyTorch work and the
// grind, with no tree launch to ride on. A batch of blobs (the batched
// commit phase) carries a step a blob: the block holding blob b's root runs
// blob b's channel (state, seed and alpha at fixed strides), with the same
// retry, so the B steps run side by side in one launch.
//
// Blob axis (commit_many, the counterpart of the batch grid dimension that
// jax.vmap prepends to each pallas_call): merkle_level and merkle_collapse
// take B blobs stacked, (B, 4 or 8, width). A stacked (B, 8, M) is not one
// level of width B * M: the pairing j / j + M/2 and the fused offsets j + t*e
// stay inside a blob, whose base is b * rows * width words (64-bit).
// merkle_level takes blob b in grid row blockIdx.y (looping past gridDim.y's
// 65535); merkle_collapse launches one cluster a blob, side by side in x, and
// a block takes its blob from its cluster's index and its rank from the
// cluster rank. A 2-D call is one blob: the same launch as before.
//
// merkle_open replaces the decommitment's device work: the value and stored
// node gathers and the rebuild of missing levels of
// frieda_tpu/core/fri.py:_auth_sibling_nodes, whose one-level steps are
// leaf_level and inner_level. Every read of one proof is one launch.
//
// Bound: none of the card's rates. A proof reads a few thousand nodes and
// hashes fewer than ten thousand compressions' worth, a few microseconds of
// the card at its integer rate; what sets the time is the launch and the
// longest chain of dependent compressions (three: four leaf hashes, two
// pairs, one pair), ~1 us of one warp's ALU work each (PERF.md).
//
// Design, merkle_open: one quad of lanes per read, from a job table built on
// the host (per layer: the columns' and the pruned tree's pointers,
// log_leaves, the offset of each stored level or -1; then one (t, k, s) row
// per read, value reads first with k = -1). A value read's lane u loads
// column u. A node read at level k gathers node bitrev(s) of level k when it
// is stored; otherwise lane u takes child u of the 2^r descendants r = k -
// base levels down: a stored node of level base = 3 * (k / 3), or, with no
// such level (k <= 2), the leaf hash of its columns. Two rounds of
// __shfl_xor_sync (lane distance 1, then 2) then hash stored-order pairs
// H(2s, 2s + 1), the even lane on the left, in the rounds l < r; lanes u >=
// 2^r repeat child u mod 2^r, so after the rounds every lane holds the node
// and lane u stores its words 2u and 2u + 1. Every lane of a warp reaches
// both shuffle rounds: quads past the last read repeat it and store nothing.
// Indices are bit-reversed on the card; addresses are 64-bit.
//
// merkle_open_queries is the same per-read body driven by the query words
// on the card instead of a host job table: the oblivious gathers of
// frieda_tpu/core/fri.py:_fri_commit_fn.run, for every raw query in draw
// order, so that a CUDA graph of the commit phase captures them after the
// transcript draws the words. Per layer t (pos = q >> t for each of the nq
// words q), 2 nq pair reads, then nq node reads per level k < log_leaves:
// read j of a layer is pair element e = j & 1 of query j >> 1, stored index
// (pos & ~1) | e, written as (4, nq, 2); then the sibling ((pos >> k) ^ 1)
// of level k, query j mod nq, written as (8, nq). A quad derives its layer
// from its index (a layer has nq (2 + log_leaves) reads and 8 nq (1 +
// log_leaves) output words), so the grid is fixed by the configuration. The
// layers come by value in the kernel's parameters (OpenLayers: the columns'
// and the tree's pointers, log_leaves and a mask of the stored levels, whose
// offsets in the flat tree follow from the mask: level k at 8 x the widths
// of the stored levels below it), so a captured launch holds its instance's
// own pointers and nothing is uploaded.
//
// Its batched form (the batched commit phase, the JAX package's vmap over
// those gathers) reads B proofs in one launch: the grid is B times one
// proof's reads, quad g reads read g mod R of blob g / R (R a proof's
// reads), whose layers, trees, query words and output lie a fixed stride
// a blob further on (OpenLayers' blob_cols and blob_flat, nq, out_stride).
//
// Its sharded form reads the layers of a mesh row whose S = 2^log_shards
// shards all lie in one block on this device (the cyclic layout of
// parallel/mesh.py: natural column x on shard x mod S), the output the same
// words at the same offsets as on one device. A read at level k of an L-leaf
// sharded layer, stored index s, takes natural x = bitrev(s, L - k): while
// the level is at least S wide it is node x / S of shard x mod S, read from
// that shard's part and tree at local stored index bitrev(x >> log_shards,
// L - log_shards - k) by the same body (a node's descendants stay on its
// shard, so a rebuild reads the shard's own base level or leaves); a
// narrower level is level k - (L - log_shards) of the top tree at s, every
// level of which is stored. This is core/merkle.py's ShardedOpening._locate
// on the card.
//
// order_openings turns those gathers into a proof's decommitment, so that
// the host only cuts it: the entries of frieda_tpu/core/fri.py:_finish_proof's
// selection, deduplicated and in the proof's order, in the same graph
// replay. One block of kOrderThreads a blob, one raw query word a thread
// while planning, every thread while writing. The words (masked to the
// domain, as the gathers mask them) are rank-sorted in shared memory by
// (word, draw index), so the first of each run of equal words is that
// position's first draw. high[e] is the highest bit in which sorted word e
// differs from word e - 1 (-1 for a repeat, 31 for e = 0): e is the first
// word under its node at every level d <= high[e], so the known nodes of
// level d are the words with high[e] >= d, in node order, each read at its
// first draw (any draw under a node gathered the same pair and path). A
// word with high[e] == d is the right child of a known pair at level d; its
// left sibling is the nearest f < e with high[f] >= d, which it marks in
// f's mask (a shared atomicOr). Bits of a word's mask: its lone levels
// (known and not in a known pair: d <= high[e], not d == high[e] for e >= 1,
// not marked) and bit 31, a first draw (an evaluation). Warp ballots and
// one pass over the warps give each set bit its place in a list of word
// indices a bit (the lone nodes of level 0, 1, ..., n - 1, then the
// evaluations), and from the list every thread writes entries: the counts
// (evaluations, each layer's FRI witness = the lone nodes of level t, each
// layer's hash witness = the lone nodes of every level above t), the values
// (the evaluation's own element of layer 0's pair, a witness its sibling's
// element of layer t's pair) and the nodes (layer t's level-(d - t) sibling
// of a lone node of level d, for every d > t), each section padded with
// zeros to its capacity, so a row is the same words whatever its draws.

#include <cooperative_groups.h>

#include "blake2s.cuh"
#include "common.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kLevelThreads = 256;
constexpr uint32_t kClusterMax = 16;      // blocks of a collapse cluster (non-portable above 8)
constexpr uint32_t kBlockNodesMax = 512;  // input nodes a collapse block takes
constexpr long long kCollapseMax = 4096;
constexpr int kMaxOuts = 13;  // distinct powers of two <= kCollapseMax
constexpr int kOpenThreads = 128;  // 32 reads a block, a quad of lanes each
constexpr int kOpenLevels = 32;    // levels of a layer, and layers of merkle_open_queries, at most
constexpr int kLayerWords = 3 + kOpenLevels;
constexpr int kOrderThreads = 1024;            // order_openings: a blob's block, one query word a thread
constexpr int kOrderSmemMax = 100 * 1024;      // its dynamic shared memory at most (opted into once)

struct CollapseOuts {
  uint32_t* ptr[kMaxOuts];
  uint32_t width[kMaxOuts];  // descending
  int count;
};

// The channel step a collapse may carry (state == nullptr: none).
struct CollapseStep {
  uint32_t* state;       // the channel: digest (8 words), n_sent
  const uint32_t* seed;  // 2 words (lo, hi) mixed first, or null
  uint32_t* alpha;       // 4 words out
  uint32_t draw_bound;   // retry while any drawn word >= draw_bound (2P)
};

// Blob b's step on its root, word w at root[w * stride]; one thread. Blob
// b's channel is at state + 9 b, its seed at seed + 2 b, its alpha at
// alpha + 4 b.
__device__ void channel_step(const CollapseStep& st, size_t b, const uint32_t* root, uint32_t stride) {
  uint32_t* state = st.state + 9 * b;
  uint32_t d[8], r[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    d[i] = state[i];
    r[i] = root[i * stride];
  }
  if (st.seed != nullptr) {
    const uint32_t v[2] = {st.seed[2 * b], st.seed[2 * b + 1]};
    frieda::hash_after(d, v, 2, d);
  }
  frieda::hash_after(d, r, 8, d);
  uint32_t n_sent = 0;
  frieda::draw_felt(d, n_sent, st.draw_bound, st.alpha + 4 * b);
#pragma unroll
  for (int i = 0; i < 8; ++i) state[i] = d[i];
  state[8] = n_sent;
}

// The layers of merkle_open_queries, by value (1,032 bytes of the 4 KB of
// kernel parameters). A layer is whole on this device (top[t] == nullptr), or
// element-sharded over the 2^log_shards shards of one mesh row, every shard
// here: then cols[t] is the (S, 4, 2^log_leaves / S) block of its parts,
// flat[t] the (S, words) block of its shards' pruned trees (one stored mask,
// `stored`, over the local levels; a row is as many words as the mask's
// levels hold), and top[t] the top tree: every level from width S (level 0,
// the shards' roots) to the root, all stored.
//
// A batch of B proofs (the batched commit phase) reads blob b's layer t at
// cols[t] + b * blob_cols[t] and its tree at flat[t] + b * blob_flat[t] (the
// rows of the (B, 4, 2^L) layer and of the (B, words) trees; whole layers
// only), 1,544 bytes in all.
struct OpenLayers {
  const uint32_t* cols[kOpenLevels];  // (4, 2^log_leaves) columns of layer t, or the (S, 4, ...) block
  const uint32_t* flat[kOpenLevels];  // its pruned tree's stored levels, ascending, or the (S, words) block
  const uint32_t* top[kOpenLevels];   // a sharded layer's top tree, else nullptr
  long long blob_cols[kOpenLevels];   // words from blob b's columns to blob b + 1's
  long long blob_flat[kOpenLevels];   // words from blob b's tree to blob b + 1's
  int log_leaves[kOpenLevels];        // of the whole layer
  uint32_t stored[kOpenLevels];  // bit k: level k is stored (in each shard's tree)
  int log_shards;
  int count;
};

// Node x of the level being read: a leaf hash of the 4 columns, or the 8
// stored words of an inner node.
template <bool LEAF>
__device__ __forceinline__ void load_node(const uint32_t* __restrict__ in, size_t width, size_t x,
                                          uint32_t (&h)[8]) {
  if (LEAF) {
    const uint32_t m[16] = {in[x], in[width + x], in[2 * width + x], in[3 * width + x],
                            0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0};
    frieda::blake2s_compress_zero(m, h);
  } else {
#pragma unroll
    for (int w = 0; w < 8; ++w) h[w] = in[w * width + x];
  }
}

// One pairing level above two nodes of the level being read.
template <bool LEAF>
__device__ __forceinline__ void pair_node(const uint32_t* __restrict__ in, size_t width, size_t x,
                                          size_t y, uint32_t (&h)[8]) {
  uint32_t a[8], b[8];
  load_node<LEAF>(in, width, x, a);
  load_node<LEAF>(in, width, y, b);
  frieda::blake2s_hash_pair(a, b, h);
}

template <bool LEAF, bool FUSED>
__global__ void __launch_bounds__(kLevelThreads)
merkle_level_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out, size_t in_width,
                    size_t out_width, uint32_t blobs) {
  const size_t j = size_t(blockIdx.x) * kLevelThreads + threadIdx.x;
  if (j >= out_width) return;
  for (uint32_t b = blockIdx.y; b < blobs; b += gridDim.y) {
    const uint32_t* __restrict__ src = in + size_t(b) * (LEAF ? 4 : 8) * in_width;
    uint32_t h[8];
    if (FUSED) {
      const size_t e = out_width;  // in_width / 8
      uint32_t l1a[8], l1b[8], l2a[8], l2b[8];
      pair_node<LEAF>(src, in_width, j, j + 4 * e, l1a);      // l1_0
      pair_node<LEAF>(src, in_width, j + 2 * e, j + 6 * e, l1b);  // l1_2
      frieda::blake2s_hash_pair(l1a, l1b, l2a);                 // l2_0
      pair_node<LEAF>(src, in_width, j + e, j + 5 * e, l1a);      // l1_1
      pair_node<LEAF>(src, in_width, j + 3 * e, j + 7 * e, l1b);  // l1_3
      frieda::blake2s_hash_pair(l1a, l1b, l2b);                 // l2_1
      frieda::blake2s_hash_pair(l2a, l2b, h);
    } else if (LEAF) {
      load_node<true>(src, in_width, j, h);
    } else {
      pair_node<false>(src, in_width, j, j + out_width, h);
    }
    uint32_t* __restrict__ dst = out + size_t(b) * 8 * out_width;
#pragma unroll
    for (int w = 0; w < 8; ++w) dst[w * out_width + j] = h[w];
  }
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// Node j of a level held as 8 rows of `stride` words, hashed with node
// j + half into node j.
__device__ __forceinline__ void pair_in_place(uint32_t* lvl, uint32_t stride, uint32_t j,
                                              uint32_t half) {
  uint32_t a[8], b[8], h[8];
#pragma unroll
  for (int w = 0; w < 8; ++w) {
    a[w] = lvl[w * stride + j];
    b[w] = lvl[w * stride + j + half];
  }
  frieda::blake2s_hash_pair(a, b, h);
#pragma unroll
  for (int w = 0; w < 8; ++w) lvl[w * stride + j] = h[w];
}

__global__ void __launch_bounds__(kBlockNodesMax / 2)
merkle_collapse_kernel(const uint32_t* __restrict__ in, const CollapseOuts outs, uint32_t m,
                       const CollapseStep step) {
  __shared__ uint32_t lvl[8 * kBlockNodesMax / 2];  // word w of local node j at lvl[w * S + j]
  __shared__ uint32_t top[8 * kClusterMax];         // rank 0's: the width-B level, word w of node b at top[w * B + b]
  cg::cluster_group cluster = cg::this_cluster();
  const uint32_t B = cluster.num_blocks(), b = cluster.block_rank();
  const size_t blob = blockIdx.x / B;  // one cluster a blob
  in += blob * 8 * m;
  const uint32_t t = threadIdx.x, T = blockDim.x;
  const uint32_t n0 = m / B;              // input nodes of this block: x = b + B * i
  const uint32_t S = n0 > 1 ? n0 / 2 : 1;  // row stride of lvl
  const bool finish = outs.width[outs.count - 1] < B;  // rank 0 ends the tree below width B
  if (finish) cluster_arrive_relaxed();  // paired with the wait before the remote stores
  int next = 0;  // the next requested width; the same in every thread of the cluster
  if (outs.width[0] == m) {
    uint32_t* __restrict__ o = outs.ptr[0] + blob * 8 * m;
    for (uint32_t i = t; i < 8 * n0; i += T) {
      const uint32_t at = (i / n0) * m + b + B * (i % n0);
      o[at] = in[at];
    }
    if (++next == outs.count) return;
  }
  if (n0 == 1) {
    if (t < 8) lvl[t] = in[t * m + b];
  } else {
    for (uint32_t j = t; j < S; j += T) {  // the first level, straight from device memory
      uint32_t a[8], c[8], h[8];
#pragma unroll
      for (int w = 0; w < 8; ++w) {
        a[w] = in[w * m + b + B * j];
        c[w] = in[w * m + b + B * (j + S)];
      }
      frieda::blake2s_hash_pair(a, c, h);
#pragma unroll
      for (int w = 0; w < 8; ++w) lvl[w * S + j] = h[w];
    }
  }
  __syncthreads();
  for (uint32_t n = S;; n /= 2) {  // this block's n nodes of the level of width n * B
    const uint32_t width = n * B;
    if (width == outs.width[next]) {
      uint32_t* __restrict__ o = outs.ptr[next] + blob * 8 * width;
      for (uint32_t i = t; i < 8 * n; i += T) {
        o[(i / n) * width + b + B * (i % n)] = lvl[(i / n) * S + i % n];  // out is (8, width)
      }
      if (++next == outs.count) {  // never when finish: a width below B is left
        if (step.state != nullptr && t == 0) channel_step(step, blob, lvl, S);  // B = 1: lvl holds the root
        return;
      }
      __syncthreads();
    }
    if (n == 1) break;
    for (uint32_t j = t; j < n / 2; j += T) pair_in_place(lvl, S, j, n / 2);
    __syncthreads();
  }
  // finish: node b of the width-B level goes to rank 0
  cluster_wait();  // every block of the cluster has started
  if (t < 8) *cluster.map_shared_rank(&top[t * B + b], 0) = lvl[t * S];
  cluster.sync();
  if (b != 0) return;
  for (uint32_t width = B;; width /= 2) {  // width B itself is never requested here
    if (width == outs.width[next]) {
      uint32_t* __restrict__ o = outs.ptr[next] + blob * 8 * width;
      for (uint32_t i = t; i < 8 * width; i += T) o[i] = top[(i / width) * B + i % width];
      if (++next == outs.count) {
        if (step.state != nullptr && t == 0) channel_step(step, blob, top, B);  // width 1: top holds the root
        return;
      }
      __syncthreads();
    }
    if (t < width / 2) pair_in_place(top, B, t, width / 2);
    __syncthreads();
  }
}

// x reversed over its low `bits` bits (0..32); bitrev(x, 0) = 0.
__device__ __forceinline__ uint32_t bitrev(uint32_t x, int bits) {
  return bits == 0 ? 0u : __brev(x) >> (32 - bits);
}

// Lane u's part of a node read: child u mod 2^r of the node's 2^r
// descendants r levels down at level `base`, whose stored level is `level`
// (8 rows of 2^(L - base) words), or with no stored level (nullptr; base 0)
// the leaf hash of the child's columns.
__device__ __forceinline__ void rebuild_lane(const uint32_t* cols, const uint32_t* level, int L, int base,
                                             uint32_t s, int r, uint32_t u, uint32_t (&h)[8]) {
  const uint32_t child = (s << r) | (u & ((1u << r) - 1));
  if (level != nullptr) {
    load_node<false>(level, size_t(1) << (L - base), bitrev(child, L - base), h);
  } else {
    load_node<true>(cols, size_t(1) << L, bitrev(child, L), h);
  }
}

// The quad's r rounds of stored-order pairs H(2s, 2s + 1), the even lane on
// the left; every lane of the warp shuffles, whatever its r.
__device__ __forceinline__ void combine_quad(uint32_t (&h)[8], int r, uint32_t u) {
#pragma unroll
  for (int l = 0; l < 2; ++l) {
    uint32_t o[8], a[8], b[8];
    const bool right = (u >> l) & 1;
#pragma unroll
    for (int w = 0; w < 8; ++w) {
      o[w] = __shfl_xor_sync(0xffffffffu, h[w], 1 << l);
      a[w] = right ? o[w] : h[w];
      b[w] = right ? h[w] : o[w];
    }
    if (l < r) frieda::blake2s_hash_pair(a, b, h);
  }
}

__global__ void __launch_bounds__(kOpenThreads)
merkle_open_kernel(const long long* __restrict__ table, int n_layers, long long n_values,
                   long long n_nodes, uint32_t* __restrict__ out) {
  const long long n_jobs = n_values + n_nodes;
  const long long j = (static_cast<long long>(blockIdx.x) * kOpenThreads + threadIdx.x) >> 2;
  const uint32_t u = threadIdx.x & 3;
  const long long* job =
      table + static_cast<long long>(n_layers) * kLayerWords + 3 * (j < n_jobs ? j : n_jobs - 1);
  const int t = static_cast<int>(job[0]);
  const int k = static_cast<int>(job[1]);
  const uint32_t s = static_cast<uint32_t>(job[2]);
  const long long* layer = table + static_cast<long long>(t) * kLayerWords;
  const uint32_t* cols = reinterpret_cast<const uint32_t*>(layer[0]);
  const uint32_t* flat = reinterpret_cast<const uint32_t*>(layer[1]);
  const int L = static_cast<int>(layer[2]);
  const long long* off = layer + 3;  // off[k]: level k's offset in flat, -1 if not stored
  uint32_t h[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  int r = 0;
  if (k < 0) {  // a value read: lane u reads column u
    if (j < n_values) out[u * n_values + j] = cols[(size_t(u) << L) + bitrev(s, L)];
  } else {
    const int base = off[k] >= 0 ? k : 3 * (k / 3);
    r = k - base;
    rebuild_lane(cols, off[base] >= 0 ? flat + off[base] : nullptr, L, base, s, r, u, h);
  }
  combine_quad(h, r, u);
  if (k >= 0 && j < n_jobs) {
    uint32_t* node = out + 4 * n_values + (j - n_values);  // word w at node[w * n_nodes]
#pragma unroll
    for (int w = 0; w < 8; ++w) {
      if ((w >> 1) == static_cast<int>(u)) node[w * n_nodes] = h[w];
    }
  }
}

__global__ void __launch_bounds__(kOpenThreads)
merkle_open_queries_kernel(const OpenLayers layers, const uint32_t* __restrict__ queries, uint32_t nq,
                           long long n_reads, long long blobs, long long out_stride,
                           uint32_t* __restrict__ out) {
  const long long g = (static_cast<long long>(blockIdx.x) * kOpenThreads + threadIdx.x) >> 2;
  const uint32_t u = threadIdx.x & 3;
  const bool live = g < n_reads * blobs;  // quads past the last read repeat it and store nothing
  const long long gl = live ? g : n_reads * blobs - 1;
  const long long blob = gl / n_reads;
  queries += blob * nq;
  out += blob * out_stride;
  long long j = gl - blob * n_reads;  // then the read's index in its layer
  int t = 0;
  size_t dst = 0;  // layer t's first output word
  for (; t + 1 < layers.count; ++t) {
    const long long reads = static_cast<long long>(nq) * (2 + layers.log_leaves[t]);
    if (j < reads) break;
    j -= reads;
    dst += size_t(8) * nq * (1 + layers.log_leaves[t]);
  }
  int L = layers.log_leaves[t];
  const uint32_t* cols = layers.cols[t] + blob * layers.blob_cols[t];
  const uint32_t* flat = layers.flat[t] + blob * layers.blob_flat[t];
  uint32_t stored = layers.stored[t];
  // The words are the transcript's draws, below 2^n; the mask only keeps a
  // bad word inside its layer.
  const uint32_t in_layer = (1u << L) - 1;
  const bool pair = j < 2ll * nq;
  const long long jn = j - 2ll * nq;
  const int k = pair ? 0 : static_cast<int>(jn / nq);  // the level read, and its output block
  const uint32_t qi = pair ? static_cast<uint32_t>(j >> 1) : static_cast<uint32_t>(jn % nq);
  const uint32_t pos = (queries[qi] >> t) & in_layer;
  // stored index s at level kl of the tree that holds the read
  uint32_t s = pair ? (pos & ~1u) | static_cast<uint32_t>(j & 1) : (pos >> k) ^ 1u;
  int kl = k;
  if (layers.top[t] != nullptr) {
    const int ls = layers.log_shards;
    if (L - k >= ls) {  // natural node x of a level at least S wide: node x / S of shard x mod S
      const uint32_t x = bitrev(s, L - k);
      const int local = L - ls;
      size_t row = 0;  // a shard's tree words
      for (uint32_t m = stored; m; m &= m - 1) row += size_t(8) << (local - (__ffs(m) - 1));
      cols += (x & ((1u << ls) - 1)) * (size_t(4) << local);
      flat += (x & ((1u << ls) - 1)) * row;
      s = bitrev(x >> ls, local - k);
      L = local;
    } else {  // a narrower level: level k - (L - ls) of the top tree, every level stored
      flat = layers.top[t];
      kl = k - (L - ls);
      L = ls;
      stored = (2u << ls) - 1;
    }
  }
  uint32_t h[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  int r = 0;
  if (pair) {  // lane u reads column u of element j & 1 of the queried pair
    if (live) out[dst + size_t(u) * 2 * nq + j] = cols[(size_t(u) << L) + bitrev(s, L)];
  } else {
    const int base = (stored >> kl) & 1 ? kl : 3 * (kl / 3);
    r = kl - base;
    const uint32_t* level = nullptr;
    if ((stored >> base) & 1) {
      size_t off = 0;  // the stored levels below base, each (8, 2^(L - level))
      for (uint32_t m = stored & ((1u << base) - 1); m; m &= m - 1) off += size_t(8) << (L - (__ffs(m) - 1));
      level = flat + off;
    }
    rebuild_lane(cols, level, L, base, s, r, u, h);
  }
  combine_quad(h, r, u);
  if (!pair && live) {
    uint32_t* node = out + dst + size_t(8) * nq * (1 + k) + qi;  // word w at node[w * nq]
#pragma unroll
    for (int w = 0; w < 8; ++w) {
      if ((w >> 1) == static_cast<int>(u)) node[size_t(w) * nq] = h[w];
    }
  }
}

// Shared memory of order_openings for nq words and a list of list_cap
// entries: the words (then each word's marked levels), the sorted words,
// their draw indices, high[], the list.
__host__ __device__ constexpr size_t order_smem_bytes(int nq, long long list_cap) {
  return size_t(11) * nq + 1 + 2 * size_t(list_cap);
}

__global__ void __launch_bounds__(kOrderThreads)
order_openings_kernel(const uint32_t* __restrict__ gathers, long long gather_stride,
                      const uint32_t* __restrict__ queries, int nq, int n, int T, long long values_cap,
                      long long nodes_cap, uint32_t* __restrict__ out, long long out_stride) {
  extern __shared__ uint32_t order_smem[];
  __shared__ uint32_t base[kOrderThreads / 32][32];  // per warp and bit: its count, then its place
  __shared__ uint32_t first[33];                     // each bit's first list entry; first[32] the total
  __shared__ uint32_t hbase[kOpenLevels + 1];        // each layer's first node entry
  __shared__ long long pair_at[kOpenLevels];         // each layer's pairs in the gathers
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  gathers += blockIdx.x * gather_stride;
  queries += blockIdx.x * static_cast<long long>(nq);
  out += blockIdx.x * out_stride;
  uint32_t* word = order_smem;
  uint32_t* pos = word + nq;
  uint16_t* slot = reinterpret_cast<uint16_t*>(pos + nq);
  int8_t* high = reinterpret_cast<int8_t*>(slot + nq);
  uint16_t* list = reinterpret_cast<uint16_t*>(high + nq + (nq & 1));

  const uint32_t in_domain = (1u << n) - 1;
  const int e = tid;  // this thread's raw word, then its sorted word
  const bool live = e < nq;
  if (live) word[e] = queries[e] & in_domain;
  __syncthreads();
  if (live) {  // rank sort: every (word, draw index) is distinct
    const uint32_t w = word[e];
    int r = 0;
    for (int j = 0; j < nq; ++j) {
      const uint32_t v = word[j];
      r += (v < w) | ((v == w) & (j < e));
    }
    pos[r] = w;
    slot[r] = static_cast<uint16_t>(e);
  }
  __syncthreads();
  int hb = -1;
  if (live) {
    const uint32_t x = e ? pos[e] ^ pos[e - 1] : 0u;
    hb = e == 0 ? 31 : (x ? 31 - __clz(x) : -1);
    high[e] = static_cast<int8_t>(hb);
    word[e] = 0;  // now the levels at which this word's node is the left child of a known pair
  }
  __syncthreads();
  if (live && e > 0 && hb >= 0) {
    int f = e - 1;
    while (high[f] < hb) --f;  // high[0] = 31 ends the walk
    atomicOr(&word[f], 1u << hb);
  }
  __syncthreads();
  uint32_t mask = 0;
  if (live && hb >= 0) {
    const uint32_t levels = hb >= n - 1 ? in_domain : (2u << hb) - 1;
    mask = (levels & ~(e ? 1u << hb : 0u) & ~word[e]) | (1u << 31);
  }
  const uint32_t below = (1u << lane) - 1;
  for (int b = 0; b < 32; ++b) {
    const uint32_t bal = __ballot_sync(0xffffffffu, (mask >> b) & 1);
    if (lane == 0) base[warp][b] = __popc(bal);
  }
  __syncthreads();
  if (tid < 32) {
    uint32_t sum = 0;
    for (int w = 0; w < kOrderThreads / 32; ++w) {
      const uint32_t c = base[w][tid];
      base[w][tid] = sum;
      sum += c;
    }
    first[tid + 1] = sum;
  }
  __syncthreads();
  if (tid == 0) {
    first[0] = 0;
    for (int b = 0; b < 32; ++b) first[b + 1] += first[b];
    hbase[0] = 0;
    long long at = 0;
    for (int t = 0; t < T; ++t) {
      pair_at[t] = at;
      at += 8ll * nq * (1 + n - t);
      hbase[t + 1] = hbase[t] + first[n] - first[t + 1];
    }
  }
  __syncthreads();
  for (int b = 0; b < 32; ++b) {
    const uint32_t bal = __ballot_sync(0xffffffffu, (mask >> b) & 1);
    if ((mask >> b) & 1) list[first[b] + base[warp][b] + __popc(bal & below)] = static_cast<uint16_t>(e);
  }
  __syncthreads();
  const uint32_t evals = first[32] - first[31];
  if (tid == 0) out[0] = evals;
  if (tid < T) {
    out[1 + tid] = first[tid + 1] - first[tid];
    out[1 + T + tid] = hbase[tid + 1] - hbase[tid];
  }
  const long long vals = 1 + 2ll * T;  // the (values_cap, 4) values
  const long long n_vals = evals + first[T];
  for (long long x = tid; x < 4 * values_cap; x += kOrderThreads) {
    const long long v = x >> 2;
    uint32_t value = 0;
    if (v < n_vals) {
      int t = 0;
      uint32_t at, el;
      if (v < evals) {  // an evaluation: its own element of layer 0's pair
        at = list[first[31] + v];
        el = pos[at] & 1;
      } else {  // layer t's FRI witness: the sibling's element of layer t's pair
        const uint32_t g = static_cast<uint32_t>(v - evals);
        while (first[t + 1] <= g) ++t;
        at = list[g];
        el = ((pos[at] >> t) & 1) ^ 1;
      }
      value = gathers[pair_at[t] + (x & 3) * 2ll * nq + 2ll * slot[at] + el];
    }
    out[vals + x] = value;
  }
  const long long nodes = vals + 4 * values_cap;  // the (nodes_cap, 8) nodes
  const uint32_t n_nodes = hbase[T];
  for (long long y = tid; y < 8 * nodes_cap; y += kOrderThreads) {
    const long long h = y >> 3;
    uint32_t value = 0;
    if (h < n_nodes) {  // layer t's hash witness: its level-(d - t) sibling of a lone node of level d > t
      int t = 0;
      while (hbase[t + 1] <= h) ++t;
      const uint32_t g = first[t + 1] + static_cast<uint32_t>(h - hbase[t]);
      int d = t + 1;
      while (first[d + 1] <= g) ++d;
      value = gathers[pair_at[t] + 8ll * nq * (1 + d - t) + (y & 7) * static_cast<long long>(nq) + slot[list[g]]];
    }
    out[nodes + y] = value;
  }
}

constexpr unsigned kGridRowsMax = 65535;  // gridDim.y's limit

template <bool LEAF, bool FUSED>
int launch_level(const void* in, void* out, size_t in_width, uint32_t blobs, cudaStream_t stream) {
  const size_t out_width = FUSED ? in_width / 8 : (LEAF ? in_width : in_width / 2);
  const dim3 grid(static_cast<unsigned>((out_width + kLevelThreads - 1) / kLevelThreads),
                  blobs < kGridRowsMax ? blobs : kGridRowsMax);
  merkle_level_kernel<LEAF, FUSED><<<grid, kLevelThreads, 0, stream>>>(
      static_cast<const uint32_t*>(in), static_cast<uint32_t*>(out), in_width, out_width, blobs);
  FRIEDA_LAUNCH_RESULT();
}

}  // namespace

// One compression alone (a pair of nodes in, their parent out), for counting
// its instructions in the SASS (chip_smoke.py phase 2); never launched.
extern "C" __global__ void frieda_blake2s_probe(const uint32_t* in, uint32_t* out) {
  uint32_t a[8], b[8], h[8];
#pragma unroll
  for (int w = 0; w < 8; ++w) {
    a[w] = in[w];
    b[w] = in[8 + w];
  }
  frieda::blake2s_hash_pair(a, b, h);
#pragma unroll
  for (int w = 0; w < 8; ++w) out[w] = h[w];
}

// in: (blobs, 4, width) u32 columns (leaf) or (blobs, 8, width) u32 levels;
// out: (blobs, 8, width) for a leaf level, (blobs, 8, width / 2) for an inner
// level, (blobs, 8, width / 8) fused. The caller checks that width is a power
// of two the mode divides.
extern "C" int frieda_merkle_level(const void* in, void* out, long long width, int leaf, int fused,
                                   int blobs, void* stream) {
  if (blobs < 1 || width < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t w = static_cast<size_t>(width);
  const uint32_t nb = static_cast<uint32_t>(blobs);
  if (leaf) {
    return fused ? launch_level<true, true>(in, out, w, nb, s) : launch_level<true, false>(in, out, w, nb, s);
  }
  return fused ? launch_level<false, true>(in, out, w, nb, s) : launch_level<false, false>(in, out, w, nb, s);
}

// in: (blobs, 8, m) u32 levels, m a power of two <= 4096; outs[j]: (blobs,
// 8, widths[j]) u32, widths descending powers of two that divide m, 1 <=
// n_out <= 13; cluster: blocks of a blob's cluster, a power of two <= 16
// with m / cluster <= 512. The grid is one cluster a blob, side by side in x
// (no 65535 cap on the blobs); the card runs as many clusters at once as fit
// and the rest in waves. state: null, or the channel step on the root (the
// design note above): the channel's 9 words, updated in place; seed: 2 words
// mixed first, or null; alpha: 4 words out; 1 <= draw_bound <= 2P; each a
// blob's at 9 b, 2 b and 4 b words (a channel a blob). A step needs m >= 2
// and the root among the widths (the last is 1).
extern "C" int frieda_merkle_collapse(const void* in, void* const* outs, const long long* widths,
                                      int n_out, long long m, int cluster, int blobs, void* state,
                                      const void* seed, void* alpha, unsigned int draw_bound,
                                      void* stream) {
  if (m < 1 || m > kCollapseMax || (m & (m - 1)) || n_out < 1 || n_out > kMaxOuts ||
      cluster < 1 || cluster > static_cast<int>(kClusterMax) || (cluster & (cluster - 1)) ||
      cluster > m || m / cluster > kBlockNodesMax || blobs < 1 ||
      static_cast<long long>(blobs) * cluster > 0x7FFFFFFFll) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (state != nullptr && (m < 2 || widths[n_out - 1] != 1 || alpha == nullptr ||
                           draw_bound == 0 || draw_bound > 2u * frieda::kP)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const CollapseStep step{static_cast<uint32_t*>(state), static_cast<const uint32_t*>(seed),
                          static_cast<uint32_t*>(alpha), draw_bound};
  CollapseOuts o{};
  for (int j = 0; j < n_out; ++j) {
    const long long w = widths[j];
    if (w < 1 || w > m || (w & (w - 1)) || (j > 0 && w >= widths[j - 1])) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    o.ptr[j] = static_cast<uint32_t*>(outs[j]);
    o.width[j] = static_cast<uint32_t>(w);
  }
  o.count = n_out;
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      merkle_collapse_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (opt_in != cudaSuccess) return static_cast<int>(opt_in);
  const uint32_t nodes = static_cast<uint32_t>(m / cluster);
  cudaLaunchConfig_t cfg{};
  cfg.gridDim = dim3(static_cast<unsigned>(cluster) * static_cast<unsigned>(blobs));
  cfg.blockDim = dim3(nodes > 64 ? nodes / 2 : 32);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr{};
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = static_cast<unsigned>(cluster);
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, merkle_collapse_kernel,
                                           static_cast<const uint32_t*>(in), o,
                                           static_cast<uint32_t>(m), step);
  if (e != cudaSuccess) return static_cast<int>(e);
  FRIEDA_LAUNCH_RESULT();
}

// table: int64 on the card, n_layers descriptors of 3 + 32 words (columns
// pointer, pruned tree pointer, log_leaves, offset of level k or -1), then
// n_values + n_nodes rows (t, k, s), values first with k = -1; out: int32,
// the (4, n_values) values, then the (8, n_nodes) nodes. The caller checks
// every row against its layer's shapes.
extern "C" int frieda_merkle_open(const void* table, int n_layers, long long n_values,
                                  long long n_nodes, void* out, void* stream) {
  if (n_layers < 1 || n_values < 0 || n_nodes < 0 || n_values + n_nodes < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long blocks = (4 * (n_values + n_nodes) + kOpenThreads - 1) / kOpenThreads;
  merkle_open_kernel<<<dim3(static_cast<unsigned>(blocks)), kOpenThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(table), n_layers, n_values, n_nodes, static_cast<uint32_t*>(out));
  FRIEDA_LAUNCH_RESULT();
}

// cols[t], flats[t]: the (4, 2^log_leaves[t]) int32 columns and the pruned
// tree of layer t, 1 <= n_layers <= 32, log_leaves < 32; stored[t]: bit k
// set for each level k the tree stores, at ascending offsets in its flat
// tensor; tops[t]: nullptr, or for a layer element-sharded over 2^log_shards
// shards (log_leaves[t] > log_shards >= 1) its top tree, cols[t] and
// flats[t] then the blocks of its shards' parts and trees (OpenLayers) and
// stored[t] the shards' mask over their local levels; queries: nq >= 1 int32
// words on the card (below 2^log_leaves[0]); out: sum over t of 8 nq (1 +
// log_leaves[t]) int32 words, per layer the (4, nq, 2) pairs, then (8, nq)
// for each level. blobs >= 1 proofs: blob b's layer t at cols[t] + b x
// blob_cols[t] words and flats[t] + b x blob_flat[t] (whole layers only when
// blobs > 1), its nq words at queries + b nq, its out at out + b x
// out_stride. The caller checks that each level k below a tree's leaf count
// is stored or has its base 3 (k / 3) stored, or k <= 2, and that a sharded
// layer's parts and a batch's blobs are the rows of their blocks.
extern "C" int frieda_merkle_open_queries(const void* const* cols, const void* const* flats,
                                          const void* const* tops, const int* log_leaves,
                                          const unsigned* stored, const long long* blob_cols,
                                          const long long* blob_flat, int n_layers, int log_shards,
                                          const void* queries, int nq, int blobs, long long out_stride,
                                          void* out, void* stream) {
  if (n_layers < 1 || n_layers > kOpenLevels || nq < 1 || log_shards < 0 || log_shards >= kOpenLevels ||
      blobs < 1 || out_stride < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  OpenLayers layers{};
  long long n_reads = 0, n_words = 0;
  for (int t = 0; t < n_layers; ++t) {
    if (log_leaves[t] < 0 || log_leaves[t] >= kOpenLevels ||
        (tops[t] != nullptr && (log_shards < 1 || log_leaves[t] <= log_shards || blobs > 1)) ||
        blob_cols[t] < 0 || blob_flat[t] < 0) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    layers.cols[t] = static_cast<const uint32_t*>(cols[t]);
    layers.flat[t] = static_cast<const uint32_t*>(flats[t]);
    layers.top[t] = static_cast<const uint32_t*>(tops[t]);
    layers.blob_cols[t] = blob_cols[t];
    layers.blob_flat[t] = blob_flat[t];
    layers.log_leaves[t] = log_leaves[t];
    layers.stored[t] = stored[t];
    n_reads += static_cast<long long>(nq) * (2 + log_leaves[t]);
    n_words += 8ll * nq * (1 + log_leaves[t]);
  }
  if (blobs > 1 && out_stride < n_words) return static_cast<int>(cudaErrorInvalidValue);
  layers.log_shards = log_shards;
  layers.count = n_layers;
  const long long blocks = (4 * n_reads * blobs + kOpenThreads - 1) / kOpenThreads;
  merkle_open_queries_kernel<<<dim3(static_cast<unsigned>(blocks)), kOpenThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      layers, static_cast<const uint32_t*>(queries), static_cast<uint32_t>(nq), n_reads, blobs, out_stride,
      static_cast<uint32_t*>(out));
  FRIEDA_LAUNCH_RESULT();
}

// gathers: blobs rows of merkle_open_queries' output (gather_stride words
// apart) for T layers of log sizes n, n - 1, ..., n - T + 1 and nq words;
// queries: blobs x nq int32 words; out: blobs rows (out_stride words apart)
// of 1 + 2T counts, the (values_cap, 4) values and the (nodes_cap, 8) nodes
// (ops/merkle.py:ordered_section), whose list of lone nodes and evaluations
// holds list_cap entries at most. 1 <= nq <= kOrderThreads, 1 <= T <= n <
// 32. The caller sizes the capacities and checks the shapes.
extern "C" int frieda_order_openings(const void* gathers, long long gather_stride, const void* queries, int nq,
                                     int n, int T, long long values_cap, long long nodes_cap, long long list_cap,
                                     int blobs, void* out, long long out_stride, void* stream) {
  const size_t smem = order_smem_bytes(nq, list_cap);
  if (nq < 1 || nq > kOrderThreads || n < 1 || n >= kOpenLevels || T < 1 || T > n || blobs < 1 ||
      values_cap < 0 || nodes_cap < 0 || list_cap < nq || smem > static_cast<size_t>(kOrderSmemMax) ||
      (blobs > 1 && (gather_stride < 1 || out_stride < 1))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      order_openings_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kOrderSmemMax);
  if (opt_in != cudaSuccess) return static_cast<int>(opt_in);
  order_openings_kernel<<<dim3(static_cast<unsigned>(blobs)), kOrderThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(gathers), gather_stride, static_cast<const uint32_t*>(queries), nq, n, T,
      values_cap, nodes_cap, static_cast<uint32_t*>(out), out_stride);
  FRIEDA_LAUNCH_RESULT();
}
