// Kernel 3, fft_pass: a group of consecutive circle-FFT butterfly stages.
//
// Replaces frieda_tpu/ops/fft_pallas.py: _run_low_pass (_low_kernel_factory),
// _run_low_pass_dilating (_low_dil_kernel_factory) and _run_mid_pass
// (_mid_kernel_factory). Same function: the stages at bits [p_lo, p_hi) of a
// (C, 2^n) M31 array in natural order,
//   out[j]       = x[j] + T_p[j mod 2^p] * x[j + 2^p]
//   out[j + 2^p] = x[j] - T_p[j mod 2^p] * x[j + 2^p]      (bit p of j clear)
// with T_p = tw[2^p - 1 + (j mod 2^p)] from one flat table indexed by bit.
//
// Bound: integer issue and device-memory bytes, near each other. A butterfly
// is 7 integer instructions per column in the SASS (chip_smoke.py counts them
// in frieda_fft_butterfly_probe: wide multiply, one fold, and a fused add-min
// for each of the reduction, the sum and the difference); each group reads and
// writes the (C, 2^n) array once, so the number of groups sets the bytes. On
// an H100 the first group is bound by instructions and the in-place group by
// its strided 64-byte rows (PERF.md, tools/torch_lde_times.py --ablate).
//
// Plan (ops/fft.py pass_plan): at most 11 stage bits a group, split evenly, so
// the main-path shapes take two launches (n = 22, 24, 26 with log_l = n - 4;
// three at n = 28). A block owns a tile of the 2^g elements that differ only
// in the group's bits, times 2^k contiguous low-bit columns: k = 4, 64-byte
// rows, except that the dilating first group keeps its tile within 2^14 words
// (k = 3 at n = 26). The tile lives in dynamic shared memory with 1/2^r0 of
// padding: up to 68 KB for 2^14 words, 512 threads and two blocks an SM, and
// 136 KB for 2^15, 1024 threads and one block. Both are above the 48 KB
// default, so the host raises the kernel's limit once, at its first launch.
//
// Rounds: the g stages run in rounds of at most 4 bits. In a round, each
// thread holds the 2^r elements that differ only in the round's bits in
// registers and runs those r stages with no barrier; the element positions
// and the twiddle offsets are worked out once per round. The first round reads
// device memory straight into registers, the last writes registers straight
// back, and shared memory only carries the exchange between rounds: g = 11
// is three rounds (4, 4, 3) and two barriers. The first group reads the
// UNDILATED coefficients: element j of the dilated vector is src[j >> src_shift],
// so the dilated array never exists in memory. Tiles are disjoint and a block
// reads all of its tile before it writes, so the later groups run in place.
//
// Twiddles: they depend on j, not on the column. The grid puts the column
// fastest (blockIdx = tile * C + c), so the C blocks that need the same table
// words run side by side and L2 serves all but the first; a block covering all
// C columns would need C times the tile, beyond the 227 KB a block may have at
// g = 11. The TPU version's transposed views, LANES and GROUP_BITS_MAX exist
// for its (8, 128) vector tiles and have no counterpart here.
//
// Kernel 9, fft_exchange (end of this file): the butterfly stage whose pairs
// lie on two shards of an element-sharded transform, which the JAX package's
// sharded FFT leaves to XLA (frieda_tpu/parallel/fft_sharded.py:298-309).

#include "common.cuh"

namespace {

constexpr int kRadixLog = 4;     // stage bits a round runs in registers, at most
constexpr int kTileLogMax = 15;  // the caller's limit on g + k (ops/fft.py TILE_LOG)
// A tile of up to 2^14 words runs 512 threads, two blocks an SM; a larger one
// takes an SM's shared memory alone and runs 1024. 64 registers a thread.
constexpr int kThreadsLogMax = 10;
// g > 4 means two rounds or more, and then the first round has r0 >= 2 bits.
constexpr int kSmemBytesMax = 4 * ((1 << kTileLogMax) + (1 << (kTileLogMax - 2)));

struct Group {
  const uint32_t* src;  // not __restrict__: later groups run in place (src == dst)
  uint32_t* dst;
  const uint32_t* tw;
  int n, p_lo, g, k, src_shift, C;
};

// g stage bits in ceil(g / 4) rounds of near-equal size, the larger first;
// a zero-stage group (a constant polynomial's dilated copy) is one round of 0.
struct Rounds {
  int count, r_lo, extra, r0;
  __host__ __device__ explicit Rounds(int g)
      : count(g == 0 ? 1 : (g + kRadixLog - 1) / kRadixLog),
        r_lo(g / count), extra(g % count), r0(r_lo + (extra > 0)) {}
  __host__ __device__ int bits(int q) const { return r_lo + (q < extra); }
};

// One butterfly on one column; t2 = 2 * twiddle.
__device__ __forceinline__ void butterfly(uint32_t& a, uint32_t& b, uint32_t t2) {
  const uint32_t u = frieda::m31_mul_dbl(b, t2);
  b = frieda::m31_sub(a, u);
  a = frieda::m31_add(a, u);
}

// One round: stage bits [s0, s0 + R) of the tile's rows, j bits [sh, sh + R).
// Tile index i = row << k | col; thread job m holds i = ib + (e << a), e < 2^R,
// ib = m with R zero bits inserted at bit a. Shared-memory slot of i:
// i + ((i >> (k + r0)) << k), 2^k words of padding after each 2^(k + r0):
// the first round's stores (lanes on i's k low bits and on the bits above its
// own) then hit 32 distinct banks, every later round's lanes cover i's 5 low
// bits, and within a round the slot of element e is slot(ib) + e * step.
template <int R>
__device__ __forceinline__ void run_round(const Group& G, uint32_t* tile, uint32_t c,
                                          uint32_t base, int s0, int r0, bool first, bool last) {
  const int k = G.k;
  const int a = s0 + k;
  const int sh = G.p_lo + s0;
  const int pad_at = k + r0;
  const uint32_t step = (1u << a) + (a >= pad_at ? 1u << (a - r0) : 0u);
  const uint32_t a_mask = (1u << a) - 1u;
  const uint32_t col_mask = (1u << k) - 1u;
  const uint32_t w_mask = (1u << sh) - 1u;
  const uint32_t jobs = 1u << (G.g + k - R);
  const size_t N = size_t(1) << G.n;
  for (uint32_t m = threadIdx.x; m < jobs; m += blockDim.x) {
    const uint32_t ib = (m & a_mask) | ((m >> a) << (a + R));
    const uint32_t jb = base | ((ib >> k) << G.p_lo) | (ib & col_mask);
    const uint32_t sb = ib + ((ib >> pad_at) << k);
    // Every loop below has a trip count fixed by R alone, so all of them
    // unroll and x[] and t2[] live in registers (an inner trip count that
    // depends on an outer index leaves a loop that indexes x[] at run time).
    uint32_t x[1 << R];
    if (first) {
      // sh >= src_shift: the round's bits sit above the dilation's
      const uint32_t* s = G.src + c * (N >> G.src_shift) + (jb >> G.src_shift);
      const uint32_t s_stride = 1u << (sh - G.src_shift);
#pragma unroll
      for (int e = 0; e < (1 << R); ++e, s += s_stride) x[e] = *s;
    } else {
#pragma unroll
      for (int e = 0; e < (1 << R); ++e) x[e] = tile[sb + uint32_t(e) * step];
    }
    // stage sh + b pairs e and e | 1 << b (bit b of e clear) with the twiddle
    // at (jb + (e << sh)) mod 2^(sh + b) = (jb & w_mask) + ((e mod 2^b) << sh);
    // t2[(1 << b) - 1 + lo] holds stage b's for e mod 2^b = lo, doubled
    const uint32_t j_stride = 1u << sh;
    uint32_t t2[(1 << R) - 1 + (R == 0)];
#pragma unroll
    for (int b = 0; b < R; ++b) {
      const uint32_t* T = G.tw + ((j_stride << b) - 1u) + (jb & w_mask);
#pragma unroll
      for (int lo = 0; lo < ((1 << R) >> 1); ++lo) {
        if (lo < (1 << b)) {
          t2[(1 << b) - 1 + lo] = *T << 1;
          T += j_stride;
        }
      }
    }
#pragma unroll
    for (int b = 0; b < R; ++b) {
#pragma unroll
      for (int q = 0; q < ((1 << R) >> 1); ++q) {
        const int lo = q & ((1 << b) - 1);
        const int e = ((q >> b) << (b + 1)) | lo;
        butterfly(x[e], x[e | (1 << b)], t2[(1 << b) - 1 + lo]);
      }
    }
    if (last) {
      uint32_t* d = G.dst + c * N + jb;
#pragma unroll
      for (int e = 0; e < (1 << R); ++e, d += j_stride) *d = x[e];
    } else {
#pragma unroll
      for (int e = 0; e < (1 << R); ++e) tile[sb + uint32_t(e) * step] = x[e];
    }
  }
}

__global__ void __launch_bounds__(1 << kThreadsLogMax, 1) fft_pass_kernel(Group G) {
  extern __shared__ uint32_t tile[];
  const uint32_t c = blockIdx.x % G.C;  // the column runs fastest: see the twiddles note
  const uint32_t t = blockIdx.x / G.C;
  const int mid_bits = G.p_lo - G.k;    // j bits [k, p_lo): fixed per block
  const uint32_t base = ((t >> mid_bits) << (G.p_lo + G.g)) |
                        ((t & ((1u << mid_bits) - 1u)) << G.k);
  const Rounds rs(G.g);
  int s0 = 0;
  for (int q = 0; q < rs.count; ++q) {
    const int r = rs.bits(q);
    const bool first = q == 0, last = q == rs.count - 1;
    if (!first) __syncthreads();
    switch (r) {
      case 0: run_round<0>(G, tile, c, base, s0, rs.r0, first, last); break;
      case 1: run_round<1>(G, tile, c, base, s0, rs.r0, first, last); break;
      case 2: run_round<2>(G, tile, c, base, s0, rs.r0, first, last); break;
      case 3: run_round<3>(G, tile, c, base, s0, rs.r0, first, last); break;
      default: run_round<4>(G, tile, c, base, s0, rs.r0, first, last); break;
    }
    s0 += r;
  }
}

// (threads, dynamic shared-memory bytes) of a group's launch.
void launch_shape(int g, int k, int* threads, int* smem_bytes) {
  const Rounds rs(g);
  const int cap = g + k > kTileLogMax - 1 ? kThreadsLogMax : kThreadsLogMax - 1;
  const int tlog = g + k - rs.r0 < cap ? g + k - rs.r0 : cap;
  const int tile = 1 << (g + k);
  *threads = 1 << tlog;
  *smem_bytes = rs.count > 1 ? 4 * (tile + (tile >> rs.r0)) : 0;
}

}  // namespace

// The butterfly alone, for counting its instructions in the SASS
// (chip_smoke.py phase 2); never launched.
extern "C" __global__ void frieda_fft_butterfly_probe(uint32_t* x, const uint32_t* t2) {
  uint32_t a = x[0], b = x[1];
  butterfly(a, b, t2[0]);
  x[0] = a;
  x[1] = b;
}

extern "C" int frieda_fft_pass_launch_shape(int g, int k, int* threads, int* smem_bytes) {
  launch_shape(g, k, threads, smem_bytes);
  return 0;
}

// src: (C, 2^(n - src_shift)) u32, dst: (C, 2^n) u32, tw: (2^n - 1,) u32.
// The caller checks 0 <= k <= p_lo <= p_hi <= n, src_shift <= p_lo and
// (p_hi - p_lo) + k <= 15.
extern "C" int frieda_fft_pass(const void* src, void* dst, const void* tw, int C, int n,
                               int p_lo, int p_hi, int k, int src_shift, void* stream) {
  static const cudaError_t opt_in = [] {
    const cudaError_t e = cudaFuncSetAttribute(
        fft_pass_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytesMax);
    return e != cudaSuccess ? e : cudaFuncSetAttribute(
        fft_pass_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
        cudaSharedmemCarveoutMaxShared);
  }();
  if (opt_in != cudaSuccess) return static_cast<int>(opt_in);
  const int g = p_hi - p_lo;
  int threads, smem;
  launch_shape(g, k, &threads, &smem);
  const dim3 grid(static_cast<unsigned>(C) << (n - g - k));
  const Group G{static_cast<const uint32_t*>(src), static_cast<uint32_t*>(dst),
                static_cast<const uint32_t*>(tw), n, p_lo, g, k, src_shift, C};
  fft_pass_kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(G);
  FRIEDA_LAUNCH_RESULT();
}

// ---------------------------------------------------------------------------
// Kernel 9, fft_exchange: one cross-shard butterfly stage.
//
// Replaces the elementwise butterfly after the ppermute in
// frieda_tpu/parallel/fft_sharded.py:298-309 (XLA; no Pallas kernel). In the
// cyclic layout of frieda_tpu_torch/parallel/ (element j on shard j mod S),
// the stage at bit p < log2 S pairs shard s with shard s + 2^p, element for
// element, with the one twiddle T_p[s mod 2^p]:
//   lo' = lo + t * hi,   hi' = lo - t * hi
// (the low shard's new value is x_self + t x_partner, the high shard's
// x_partner - t x_self). Rows: lo and hi are `rows` rows of `len` words, row
// r = a * B + b at word offset a * a_stride + b * len of each, twiddle tw[b];
// the S shards of one device as one (S, C, 2^m) tensor are one launch a
// stage (a = pair group, b = s mod 2^p). `write` bit 0 stores lo', bit 1
// stores hi': a shard whose partner lives in another process keeps its own
// half only.
//
// Bound: device-memory bytes, 16 a pair (two words read, two written) for 7
// integer instructions; one thread a pair, a warp on 128 contiguous bytes of
// each row, no shared memory.

namespace {

constexpr int kExchangeThreads = 256;

__global__ void __launch_bounds__(kExchangeThreads)
fft_exchange_kernel(uint32_t* lo, uint32_t* hi, const uint32_t* __restrict__ tw, unsigned b_count,
                    size_t a_stride, size_t len, int write) {
  const size_t l = static_cast<size_t>(blockIdx.x) * kExchangeThreads + threadIdx.x;
  if (l >= len) return;
  const unsigned a = blockIdx.y / b_count, b = blockIdx.y - a * b_count;
  const size_t off = a * a_stride + b * len + l;
  uint32_t x = lo[off], y = hi[off];
  butterfly(x, y, tw[b] << 1);
  if (write & 1) lo[off] = x;
  if (write & 2) hi[off] = y;
}

}  // namespace

// lo, hi: rows of len u32 words, row r = a * b_count + b at a * a_stride +
// b * len; tw: b_count canonical twiddles. Updates lo and hi in place (as
// `write` says). The caller checks the shapes and that the rows do not
// overlap.
extern "C" int frieda_fft_exchange(void* lo, void* hi, const void* tw, int rows, int b_count,
                                   long long a_stride, long long len, int write, void* stream) {
  if (rows < 1 || rows > 65535 || b_count < 1 || rows % b_count || len < 1 || write < 1 || write > 3)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((len + kExchangeThreads - 1) / kExchangeThreads),
                  static_cast<unsigned>(rows));
  fft_exchange_kernel<<<grid, kExchangeThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(lo), static_cast<uint32_t*>(hi), static_cast<const uint32_t*>(tw),
      static_cast<unsigned>(b_count), static_cast<size_t>(a_stride), static_cast<size_t>(len), write);
  FRIEDA_LAUNCH_RESULT();
}
