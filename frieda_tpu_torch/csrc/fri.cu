// Kernel 6, fri_fold: one FRI fold of QM31 columns, (4, M) -> (4, M/2), or of
// a batch (B, 4, M) -> (B, 4, M/2).
//
// Replaces fold_c and fold_l of frieda_tpu/core/fri.py:_fri_commit_fn
// (:211-225), which XLA fuses inside the commit phase's one dispatch; they
// have no Pallas kernel. With lo = values[:, k] and hi = values[:, k + M/2]
// (natural-order halves: the conjugate points of the circle fold, the +-x
// pairs of a line fold),
//   g[k] = (lo + hi) + alpha * (lo - hi) * inv[k]
// in QM31, inv = ys_inv for the circle fold, xs_layers_inv[l] for line fold
// l. alpha is read from device memory, where the transcript kernel drew it
// (csrc/channel.cu), so nothing waits for the host between a layer's root
// and its fold.
//
// Bound: device-memory bytes. An output element reads 8 value words and one
// inverse and writes 4 words (52 bytes) for ~150 integer instructions
// (chip_smoke.py counts them in frieda_fri_fold_probe), well under the
// card's 10 instructions a byte.
//
// Design: one thread per k, so every load and store of a warp is 128
// contiguous bytes; each thread reads alpha (4 words, one cached line for
// the whole launch) and doubles it once for m31_mul_dbl.
//
// Blob axis (the batched commit phase, the counterpart of jax.vmap over
// fold_c / fold_l; and a block of shards of one mesh row): B stacked
// (B, 4, M) values fold to (B, 4, M/2) in one launch, blob b in grid row
// blockIdx.y (looping past gridDim.y's 65535). Each blob reads its alpha at
// b * alpha_stride (4: one draw a blob; 0: the shards of one layer share
// theirs) and its inverse table at b * inv_stride (0: one (M/2,) table
// shared by every blob; M/2: a (B, M/2) table a row, a shard's slice).

#include "common.cuh"

namespace {

using frieda::m31_add;
using frieda::m31_mul_dbl;
using frieda::m31_sub;

constexpr int kThreads = 256;

// g = alpha * f in QM31 = CM31[u] / (u^2 - 2 - i), from a2 = 2 * alpha:
// (a + b u)(c + d u) = (ac + bd (2 + i)) + (ad + bc) u.
__device__ __forceinline__ void qm31_mul_dbl(const uint32_t (&a2)[4], const uint32_t (&f)[4],
                                             uint32_t (&g)[4]) {
  const uint32_t ac0 = m31_sub(m31_mul_dbl(f[0], a2[0]), m31_mul_dbl(f[1], a2[1]));
  const uint32_t ac1 = m31_add(m31_mul_dbl(f[1], a2[0]), m31_mul_dbl(f[0], a2[1]));
  const uint32_t bd0 = m31_sub(m31_mul_dbl(f[2], a2[2]), m31_mul_dbl(f[3], a2[3]));
  const uint32_t bd1 = m31_add(m31_mul_dbl(f[3], a2[2]), m31_mul_dbl(f[2], a2[3]));
  const uint32_t ad0 = m31_sub(m31_mul_dbl(f[2], a2[0]), m31_mul_dbl(f[3], a2[1]));
  const uint32_t ad1 = m31_add(m31_mul_dbl(f[3], a2[0]), m31_mul_dbl(f[2], a2[1]));
  const uint32_t bc0 = m31_sub(m31_mul_dbl(f[0], a2[2]), m31_mul_dbl(f[1], a2[3]));
  const uint32_t bc1 = m31_add(m31_mul_dbl(f[1], a2[2]), m31_mul_dbl(f[0], a2[3]));
  g[0] = m31_add(ac0, m31_sub(m31_add(bd0, bd0), bd1));
  g[1] = m31_add(ac1, m31_add(bd0, m31_add(bd1, bd1)));
  g[2] = m31_add(ad0, bc0);
  g[3] = m31_add(ad1, bc1);
}

// One output element: g = (lo + hi) + alpha * (lo - hi) * inv, from a2 =
// 2 * alpha and inv2 = 2 * inv.
__device__ __forceinline__ void fold_one(const uint32_t (&lo)[4], const uint32_t (&hi)[4],
                                         const uint32_t (&a2)[4], uint32_t inv2, uint32_t (&g)[4]) {
  uint32_t f[4], af[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) f[c] = m31_mul_dbl(m31_sub(lo[c], hi[c]), inv2);
  qm31_mul_dbl(a2, f, af);
#pragma unroll
  for (int c = 0; c < 4; ++c) g[c] = m31_add(m31_add(lo[c], hi[c]), af[c]);
}

__global__ void __launch_bounds__(kThreads)
fri_fold_kernel(const uint32_t* __restrict__ values, const uint32_t* __restrict__ alpha,
                const uint32_t* __restrict__ inv, uint32_t* __restrict__ out, size_t half,
                uint32_t blobs, size_t alpha_stride, size_t inv_stride) {
  const size_t k = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (k >= half) return;
  const size_t m = 2 * half;
  for (uint32_t b = blockIdx.y; b < blobs; b += gridDim.y) {
    const uint32_t* __restrict__ v = values + size_t(b) * 4 * m;
    const uint32_t* __restrict__ a = alpha + size_t(b) * alpha_stride;
    uint32_t a2[4], lo[4], hi[4], g[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      a2[c] = 2u * a[c];
      lo[c] = v[c * m + k];
      hi[c] = v[c * m + half + k];
    }
    fold_one(lo, hi, a2, 2u * inv[size_t(b) * inv_stride + k], g);
    uint32_t* __restrict__ o = out + size_t(b) * 4 * half;
#pragma unroll
    for (int c = 0; c < 4; ++c) o[c * half + k] = g[c];
  }
}

}  // namespace

// One element's fold alone, for counting its instructions in the SASS
// (chip_smoke.py phase 2); never launched. in: lo[4], hi[4], alpha[4], inv.
extern "C" __global__ void frieda_fri_fold_probe(const uint32_t* in, uint32_t* out) {
  uint32_t lo[4], hi[4], a2[4], g[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    lo[c] = in[c];
    hi[c] = in[4 + c];
    a2[c] = 2u * in[8 + c];
  }
  fold_one(lo, hi, a2, 2u * in[12], g);
#pragma unroll
  for (int c = 0; c < 4; ++c) out[c] = g[c];
}

// values: (blobs, 4, 2 * half) u32 canonical M31; alpha: 4 words a blob, at
// b * alpha_stride; inv: (half,) inverses a blob, at b * inv_stride; out:
// (blobs, 4, half). The caller checks the shapes.
extern "C" int frieda_fri_fold(const void* values, const void* alpha, const void* inv, void* out,
                               long long half, int blobs, long long alpha_stride, long long inv_stride,
                               void* stream) {
  if (half < 1 || blobs < 1 || alpha_stride < 0 || inv_stride < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long blocks = (half + kThreads - 1) / kThreads;
  const dim3 grid(static_cast<unsigned>(blocks), blobs < 65535 ? static_cast<unsigned>(blobs) : 65535u);
  fri_fold_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(values), static_cast<const uint32_t*>(alpha),
      static_cast<const uint32_t*>(inv), static_cast<uint32_t*>(out), static_cast<size_t>(half),
      static_cast<uint32_t>(blobs), static_cast<size_t>(alpha_stride), static_cast<size_t>(inv_stride));
  FRIEDA_LAUNCH_RESULT();
}
