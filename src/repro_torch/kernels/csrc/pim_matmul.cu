// Macro-tiled PIM matmul on Hopper (sm_90a): (M, K) int8 x (K, N) int8 ->
// (M, N) float32 on the accumulation grid.
//
// Replaces the TPU kernel `repro/kernels/pim_matmul.py::pim_matmul_int_pallas`
// (body `_pim_matmul_kernel`, ADC `_adc`).  Ideal mode: the exact int32 dot,
// converted once to float32.  Quantized mode: every 16-row word-line group's
// int32 partial sum goes through the saturating ADC,
// code = clip(rint(psum / step), lo, hi), and the output is sum(code) * step.
//
// Exactness: the partial sum is an int32 below 2^24, so its float32 value is
// exact; the division is IEEE (__fdiv_rn, no fast math) and rintf rounds half
// to even, as XLA's round does.  The ADC codes are summed in int32 and
// multiplied by `step` once, so the result does not depend on the order of
// the sum.  The reference sums code * step in float32, which equals this
// wherever that float32 sum is exact (|sum(code)| * 16129 < 2^24 at the
// defaults: every K up to 512 rows per output, and any K whose codes stay
// small).  The plain version (`kernels/pim_matmul.py`) sums the same way, so
// kernel and plain agree bit for bit at every K.
//
// Layout: x is row-major (M, K).  w is read as stored, at its offset and
// strides: either k-contiguous (the deployed layout, a (K, N) view of an
// (N, K) store) or n-contiguous (row-major (K, N), e.g. a layer of a stacked
// (L, K, N) block).  K need not be a multiple of 16: bytes past K load as
// zero, which is what the reference's zero padding gives (a zero group's
// partial sum is 0 and its ADC code is 0).
//
// Tiling: a CTA computes a BM x 64 output tile over a K range, 64 rows of K
// per shared-memory stage, and 256 threads each own TM x 4 outputs.  Each
// group of 16 rows is four __dp4a per output (exact int32), then one ADC.
// Small M (decode: M = 4..8) leaves few (M, N) tiles, so K is split across
// CTAs (grid z) until the card has about two CTAs per SM; each split writes
// its int32 sums, and a second kernel adds the splits and converts.  Integer
// sums make the split exact.
//
// What bounds it on the H100: at decode the weight bytes (K * N, read once)
// over HBM; at prefill the int8 dot products and the ADC's division per group
// and output, on the CUDA cores.  Tensor cores (s8 mma.sync m16n8k16, whose
// k = 16 is one word-line group) and cp.async/TMA double buffering are the
// next steps for speed.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBN = 64;
constexpr int kBK = 64;
constexpr int kKW = kBK / 4;   // 32-bit words per tile row
constexpr int kLD = kKW + 1;   // padded: 16 rows read at one column hit 16 banks

// Bytes p[0..3] as a little-endian word; bytes at or past `avail` read 0.
// `vec`: p is 4-byte aligned whenever avail >= 4.
__device__ __forceinline__ uint32_t load4(const int8_t* __restrict__ p,
                                          long avail, int vec) {
  if (avail <= 0) return 0u;
  if (vec && avail >= 4) return __ldg(reinterpret_cast<const unsigned int*>(p));
  uint32_t v = 0u;
  for (int i = 0; i < 4 && i < avail; ++i)
    v |= static_cast<uint32_t>(static_cast<uint8_t>(p[i])) << (8 * i);
  return v;
}

__device__ __forceinline__ int adc_code(int psum, float step, float lo,
                                        float hi) {
  const float c = rintf(__fdiv_rn(__int2float_rn(psum), step));
  return static_cast<int>(fminf(fmaxf(c, lo), hi));
}

__device__ __forceinline__ float finish(int acc, int quantized, float step) {
  const float a = __int2float_rn(acc);
  return quantized ? __fmul_rn(a, step) : a;
}

template <int TM>
__global__ void __launch_bounds__(kThreads)
pim_matmul_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                  float* __restrict__ out, int* __restrict__ part, int M,
                  int N, int K, long ldk, long ldn, int kmajor, int vec_x,
                  int vec_w, int k_split, int quantized, float step, float lo,
                  float hi) {
  constexpr int BM = 16 * TM;
  __shared__ int xs[BM][kLD];
  __shared__ int ws[kBN][kLD];  // column-major: 16 rows of a column = 4 words
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * kBN;
  const int k_begin = blockIdx.z * k_split;
  const int k_end = min(K, k_begin + k_split);

  int acc[TM][4];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  for (int kt = k_begin; kt < k_end; kt += kBK) {
    for (int i = tid; i < BM * kKW; i += kThreads) {
      const int r = i / kKW, c = i - r * kKW;
      const int m = m0 + r, k = kt + 4 * c;
      xs[r][c] = m < M ? static_cast<int>(load4(x + (size_t)m * K + k,
                                                k_end - k, vec_x))
                       : 0;
    }
    if (kmajor) {
      for (int i = tid; i < kBN * kKW; i += kThreads) {
        const int c = i / kKW, kw = i - c * kKW;
        const int n = n0 + c, k = kt + 4 * kw;
        ws[c][kw] = n < N ? static_cast<int>(load4(w + n * ldn + k,
                                                   k_end - k, vec_w))
                          : 0;
      }
    } else {
      // a 4 x 4 byte block per thread (rows k..k+3, columns n..n+3),
      // transposed so that each column's 4 rows form one word
      const int kb = tid / 16, nb = tid % 16;
      const int k = kt + 4 * kb, n = n0 + 4 * nb;
      uint32_t r[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        r[i] = k + i < k_end ? load4(w + (k + i) * ldk + n, N - n, vec_w) : 0u;
      const uint32_t a = __byte_perm(r[0], r[1], 0x5140);
      const uint32_t b = __byte_perm(r[2], r[3], 0x5140);
      const uint32_t c = __byte_perm(r[0], r[1], 0x7362);
      const uint32_t d = __byte_perm(r[2], r[3], 0x7362);
      ws[4 * nb + 0][kb] = static_cast<int>(__byte_perm(a, b, 0x5410));
      ws[4 * nb + 1][kb] = static_cast<int>(__byte_perm(a, b, 0x7632));
      ws[4 * nb + 2][kb] = static_cast<int>(__byte_perm(c, d, 0x5410));
      ws[4 * nb + 3][kb] = static_cast<int>(__byte_perm(c, d, 0x7632));
    }
    __syncthreads();
#pragma unroll
    for (int g = 0; g < kKW / 4; ++g) {  // word-line groups of 16 rows
      int xv[TM][4], wv[4][4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
#pragma unroll
        for (int i = 0; i < TM; ++i) xv[i][q] = xs[ty + 16 * i][4 * g + q];
#pragma unroll
        for (int j = 0; j < 4; ++j) wv[j][q] = ws[tx + 16 * j][4 * g + q];
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          int p = 0;
#pragma unroll
          for (int q = 0; q < 4; ++q) p = __dp4a(xv[i][q], wv[j][q], p);
          acc[i][j] += quantized ? adc_code(p, step, lo, hi) : p;
        }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n >= N) continue;
      if (part)
        part[((size_t)blockIdx.z * M + m) * N + n] = acc[i][j];
      else
        out[(size_t)m * N + n] = finish(acc[i][j], quantized, step);
    }
  }
}

// out = finish(sum over the splits), splits added in order
__global__ void pim_matmul_splits_kernel(const int* __restrict__ part,
                                         float* __restrict__ out, long mn,
                                         int splits, int quantized,
                                         float step) {
  for (long i = blockIdx.x * (long)blockDim.x + threadIdx.x; i < mn;
       i += (long)gridDim.x * blockDim.x) {
    int acc = 0;
    for (int s = 0; s < splits; ++s) acc += part[s * mn + i];
    out[i] = finish(acc, quantized, step);
  }
}

}  // namespace

// Rows of M per CTA tile: 16 for small M (decode), else 64.
extern "C" int pim_matmul_block_m(int m) { return m <= 16 ? 16 : 64; }

// Launches on `stream`; returns cudaGetLastError() (0 on success).
// w[k, n] is at w + k * ldk + n * ldn, with ldk == 1 (kmajor) or ldn == 1.
// `part` is null for splits == 1, else (splits, M, N) int32 scratch; K rows
// [s * k_split, (s + 1) * k_split) belong to split s, k_split % 64 == 0.
extern "C" int pim_matmul_launch(const void* x, const void* w, void* out,
                                 void* part, int m, int n, int k, long ldk,
                                 long ldn, int kmajor, int vec_x, int vec_w,
                                 int splits, int k_split, int quantized,
                                 float step, float lo, float hi,
                                 void* stream) {
  if (k_split % kBK != 0 || (splits > 1) != (part != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int bm = pim_matmul_block_m(m);
  dim3 grid((n + kBN - 1) / kBN, (m + bm - 1) / bm, splits);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* xp = static_cast<const int8_t*>(x);
  const int8_t* wp = static_cast<const int8_t*>(w);
  float* op = static_cast<float*>(out);
  int* pp = static_cast<int*>(part);
  if (bm == 16)
    pim_matmul_kernel<1><<<grid, kThreads, 0, s>>>(
        xp, wp, op, pp, m, n, k, ldk, ldn, kmajor, vec_x, vec_w, k_split,
        quantized, step, lo, hi);
  else
    pim_matmul_kernel<4><<<grid, kThreads, 0, s>>>(
        xp, wp, op, pp, m, n, k, ldk, ldn, kmajor, vec_x, vec_w, k_split,
        quantized, step, lo, hi);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const long mn = static_cast<long>(m) * n;
  const long need = (mn + 255) / 256;
  const int blocks = static_cast<int>(need < 4096 ? need : 4096);
  pim_matmul_splits_kernel<<<blocks, 256, 0, s>>>(pp, op, mn, splits,
                                                  quantized, step);
  return static_cast<int>(cudaGetLastError());
}
