// Kernels 1 and 2: Merkle tree levels over BLAKE2s zero-state compressions.
//
// merkle_level replaces frieda_tpu/ops/merkle_pallas.py: leaf_level
// (_leaf_kernel), inner_level (_inner_kernel), leaf3_level (_leaf3_kernel,
// _combine3) and inner3_level (_inner3_kernel). merkle_collapse replaces
// collapse_level / collapse_multi (_collapse_kernel_factory): every requested
// output width of the narrow tail in one launch.
//
// Bound: integer ALU work. A compression is ~1,100 32-bit operations for
// 32-64 bytes in and 32 bytes out, so the leaf and inner levels are limited
// by the SMs' integer throughput, not by device memory.
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
// Design, merkle_collapse: one block of 512 threads holds a level of width
// m <= 4096 in shared memory (8 * m u32, 128 KB at 4096, which needs the
// opt-in above 48 KB) and halves it in place down to the smallest requested
// width. Thread x reads nodes x and x + half and writes node x, so no node is
// written while another thread reads it; a barrier separates levels. When a
// level's width is one of the requested widths (descending powers of two
// dividing m, at most kMaxOuts of them) the block copies it out, and a
// barrier keeps the next level from overwriting it before the copy ends. The
// prover's pruned trees ask for m/8, m/64, ..., 1 (every third level); the
// commit asks for 1. The TPU version keeps up to 8 x 32768 nodes (1 MiB) in
// VMEM; a Hopper block has at most 227 KB, so merkle_level keeps fusing down
// to width 4096 first.

#include "blake2s.cuh"
#include "common.cuh"

namespace {

constexpr int kLevelThreads = 256;
constexpr int kCollapseThreads = 512;
constexpr long long kCollapseMax = 4096;
constexpr int kMaxOuts = 13;  // distinct powers of two <= kCollapseMax

struct CollapseOuts {
  uint32_t* ptr[kMaxOuts];
  uint32_t width[kMaxOuts];  // descending
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
                    size_t out_width) {
  const size_t j = size_t(blockIdx.x) * kLevelThreads + threadIdx.x;
  if (j >= out_width) return;
  uint32_t h[8];
  if (FUSED) {
    const size_t e = out_width;  // in_width / 8
    uint32_t l1a[8], l1b[8], l2a[8], l2b[8];
    pair_node<LEAF>(in, in_width, j, j + 4 * e, l1a);      // l1_0
    pair_node<LEAF>(in, in_width, j + 2 * e, j + 6 * e, l1b);  // l1_2
    frieda::blake2s_hash_pair(l1a, l1b, l2a);                // l2_0
    pair_node<LEAF>(in, in_width, j + e, j + 5 * e, l1a);      // l1_1
    pair_node<LEAF>(in, in_width, j + 3 * e, j + 7 * e, l1b);  // l1_3
    frieda::blake2s_hash_pair(l1a, l1b, l2b);                // l2_1
    frieda::blake2s_hash_pair(l2a, l2b, h);
  } else if (LEAF) {
    load_node<true>(in, in_width, j, h);
  } else {
    pair_node<false>(in, in_width, j, j + out_width, h);
  }
#pragma unroll
  for (int w = 0; w < 8; ++w) out[w * out_width + j] = h[w];
}

__global__ void __launch_bounds__(kCollapseThreads)
merkle_collapse_kernel(const uint32_t* __restrict__ in, const CollapseOuts outs, uint32_t m) {
  extern __shared__ uint32_t lvl[];  // word w of node x at lvl[w * m + x]
  for (uint32_t i = threadIdx.x; i < 8 * m; i += kCollapseThreads) lvl[i] = in[i];
  __syncthreads();
  int next = 0;  // the next requested width; the same in every thread
  for (uint32_t width = m;; width /= 2) {
    if (width == outs.width[next]) {
      uint32_t* __restrict__ o = outs.ptr[next];
      for (uint32_t i = threadIdx.x; i < 8 * width; i += kCollapseThreads) {
        o[i] = lvl[(i / width) * m + i % width];  // out is (8, width)
      }
      if (++next == outs.count) return;
      __syncthreads();
    }
    const uint32_t half = width / 2;
    for (uint32_t x = threadIdx.x; x < half; x += kCollapseThreads) {
      uint32_t a[8], b[8], h[8];
#pragma unroll
      for (int w = 0; w < 8; ++w) {
        a[w] = lvl[w * m + x];
        b[w] = lvl[w * m + x + half];
      }
      frieda::blake2s_hash_pair(a, b, h);
#pragma unroll
      for (int w = 0; w < 8; ++w) lvl[w * m + x] = h[w];
    }
    __syncthreads();
  }
}

template <bool LEAF, bool FUSED>
int launch_level(const void* in, void* out, size_t in_width, cudaStream_t stream) {
  const size_t out_width = FUSED ? in_width / 8 : (LEAF ? in_width : in_width / 2);
  const dim3 grid(static_cast<unsigned>((out_width + kLevelThreads - 1) / kLevelThreads));
  merkle_level_kernel<LEAF, FUSED><<<grid, kLevelThreads, 0, stream>>>(
      static_cast<const uint32_t*>(in), static_cast<uint32_t*>(out), in_width, out_width);
  FRIEDA_LAUNCH_RESULT();
}

}  // namespace

// in: (4, width) u32 columns (leaf) or (8, width) u32 level; out: (8, width)
// for a leaf level, (8, width / 2) for an inner level, (8, width / 8) fused.
// The caller checks that width is a power of two the mode divides.
extern "C" int frieda_merkle_level(const void* in, void* out, long long width, int leaf, int fused,
                                   void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t w = static_cast<size_t>(width);
  if (leaf) return fused ? launch_level<true, true>(in, out, w, s) : launch_level<true, false>(in, out, w, s);
  return fused ? launch_level<false, true>(in, out, w, s) : launch_level<false, false>(in, out, w, s);
}

// in: (8, m) u32 level, m a power of two <= 4096; outs[j]: (8, widths[j])
// u32, widths descending powers of two that divide m, 1 <= n_out <= 13.
extern "C" int frieda_merkle_collapse(const void* in, void* const* outs, const long long* widths,
                                      int n_out, long long m, void* stream) {
  if (m < 1 || m > kCollapseMax || (m & (m - 1)) || n_out < 1 || n_out > kMaxOuts) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
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
  const size_t smem = size_t(8) * static_cast<size_t>(m) * sizeof(uint32_t);
  const cudaError_t attr = cudaFuncSetAttribute(
      merkle_collapse_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  merkle_collapse_kernel<<<1, kCollapseThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(in), o, static_cast<uint32_t>(m));
  FRIEDA_LAUNCH_RESULT();
}
