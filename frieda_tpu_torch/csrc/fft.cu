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
// Bound: device-memory bytes. A stage is one M31 product and an add and a
// subtract per pair of u32 words, far below the card's integer rate, so a
// stage-per-launch loop would cost one full read and write of the array per
// stage (24 at n = 24 with log_l = 20).
//
// Design: a block loads the 2^g elements that differ only in the group's
// bits, times 2^k contiguous low-bit columns (g + k <= 12, 16 KB), into
// shared memory, runs all g stages there with a barrier between stages, and
// writes the tile back: one read and one write of the array per group, about
// 3 groups at n = 24. The k low-bit columns make neighbouring threads touch
// neighbouring words. The first group reads the UNDILATED coefficients:
// element j of the dilated vector is src[j >> src_shift], so the dilated
// array never exists in memory. Tiles are disjoint and a block reads only
// what it writes, so the later groups run in place. The TPU version's
// transposed views, LANES and GROUP_BITS_MAX exist for its (8, 128) vector
// tiles and have no counterpart here.

#include "common.cuh"

namespace {

constexpr int kTileLog = 12;
constexpr int kThreads = 256;

// src is not __restrict__: later groups run in place (src == dst).
__global__ void __launch_bounds__(kThreads)
fft_pass_kernel(const uint32_t* src, uint32_t* dst, const uint32_t* __restrict__ tw,
                int n, int p_lo, int g, int k, int src_shift, uint32_t blocks_per_col) {
  __shared__ uint32_t tile[1 << kTileLog];
  const uint32_t c = blockIdx.x / blocks_per_col;
  const uint32_t rem = blockIdx.x % blocks_per_col;
  const int mid_bits = p_lo - k;  // bits [k, p_lo): fixed per block
  const uint32_t mid = rem & ((1u << mid_bits) - 1u);
  const uint32_t hi = rem >> mid_bits;  // bits [p_lo + g, n): fixed per block
  const uint32_t base = (hi << (p_lo + g)) | (mid << k);
  const size_t N = size_t(1) << n;
  const uint32_t* s = src + c * (N >> src_shift);
  uint32_t* d = dst + c * N;
  const uint32_t tile_n = 1u << (g + k);
  const uint32_t col_mask = (1u << k) - 1u;

  // tile index i = r * 2^k + col  <->  j = base | r << p_lo | col
  for (uint32_t i = threadIdx.x; i < tile_n; i += kThreads) {
    const uint32_t j = base | ((i >> k) << p_lo) | (i & col_mask);
    tile[i] = s[j >> src_shift];
  }
  __syncthreads();

  for (int st = 0; st < g; ++st) {
    const int p = p_lo + st;
    const uint32_t* T = tw + ((1u << p) - 1u);
    const uint32_t pmask = (1u << p) - 1u;
    const uint32_t low_r = (1u << st) - 1u;
    for (uint32_t q = threadIdx.x; q < tile_n / 2; q += kThreads) {
      const uint32_t col = q & col_mask;
      const uint32_t rr = q >> k;
      const uint32_t r0 = ((rr >> st) << (st + 1)) | (rr & low_r);  // bit st clear
      const uint32_t i0 = (r0 << k) | col;
      const uint32_t i1 = i0 | (1u << (st + k));
      const uint32_t j0 = base | (r0 << p_lo) | col;
      const uint32_t u = frieda::m31_mul(T[j0 & pmask], tile[i1]);
      const uint32_t a = tile[i0];
      tile[i0] = frieda::m31_add(a, u);
      tile[i1] = frieda::m31_sub(a, u);
    }
    __syncthreads();
  }

  for (uint32_t i = threadIdx.x; i < tile_n; i += kThreads) {
    const uint32_t j = base | ((i >> k) << p_lo) | (i & col_mask);
    d[j] = tile[i];
  }
}

}  // namespace

// src: (C, 2^(n - src_shift)) u32, dst: (C, 2^n) u32, tw: (2^n - 1,) u32.
// The caller checks 0 <= k <= p_lo <= p_hi <= n and (p_hi - p_lo) + k <= 12.
extern "C" int frieda_fft_pass(const void* src, void* dst, const void* tw, int C, int n,
                               int p_lo, int p_hi, int k, int src_shift, void* stream) {
  const int g = p_hi - p_lo;
  const uint32_t blocks_per_col = 1u << (n - g - k);
  const dim3 grid(static_cast<unsigned>(C) * blocks_per_col);
  fft_pass_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(src), static_cast<uint32_t*>(dst),
      static_cast<const uint32_t*>(tw), n, p_lo, g, k, src_shift, blocks_per_col);
  FRIEDA_LAUNCH_RESULT();
}
