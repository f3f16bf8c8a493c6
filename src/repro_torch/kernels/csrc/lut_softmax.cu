// LUT softmax (shifted mode) on Hopper (sm_90a): (R, S) int32 score codes
// and an (R, S) mask -> (R, S) int32 Q0.<out_frac_bits> probability codes.
//
// Replaces the TPU kernel `repro/kernels/lut_softmax.py::lut_softmax_pallas`
// (body `_lut_softmax_kernel`).  Per row: the masked row max m (kNeg when the
// row is all masked); e = table[clip(m - s, 0, 255)], 0 where masked;
// denom = max(sum(e), 1); codes = clip(floor(e * 2^out_frac / denom), 0,
// out_max).
//
// One CTA per row and three passes over it: masked max, exact sum, codes.
// The 256-entry table sits in shared memory (the TPU's one-hot x table
// matmul existed only for want of a VMEM gather).  The sum of exps is an
// integer (each entry is below 2^16) kept in 64 bits, rounded once to
// float32, so it does not depend on the order of the sum; the reference's
// float32 sum equals it while the sum stays below 2^24 (about 512 positions
// at the table's maximum).  The divide is IEEE (__fdiv_rn, no fast math),
// then floor, as the reference's.  The plain version
// (`kernels/lut_softmax.py`) does the same, so the two agree bit for bit.
//
// What bounds it on the H100: bytes.  Each row's scores (4 B) and mask (1 B)
// are read three times, mostly from L2 after the first pass, and its codes
// (4 B) written once; the arithmetic is a few operations per element.
// Keeping a row in shared memory between the passes, and several short
// rows per CTA, are the next steps for speed.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kNeg = -(1 << 24);  // masked score code, below any real code

__device__ __forceinline__ int block_max(int v, int* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(0xffffffffu, v, o));
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  v = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) v = max(v, red[w]);
  return v;
}

__device__ __forceinline__ long long block_sum(long long v, long long* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  v = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) v += red[w];
  return v;
}

__global__ void __launch_bounds__(kThreads)
lut_softmax_kernel(const int* __restrict__ scores,
                   const uint8_t* __restrict__ mask,
                   const int* __restrict__ table, int* __restrict__ out,
                   int S, float out_scale, float out_max) {
  __shared__ int tab[256];
  __shared__ int red_max[kWarps];
  __shared__ long long red_sum[kWarps];
  for (int i = threadIdx.x; i < 256; i += kThreads) tab[i] = table[i];
  const size_t row = static_cast<size_t>(blockIdx.x) * S;
  const int* s = scores + row;
  const uint8_t* mk = mask + row;

  int m = kNeg;
  for (int j = threadIdx.x; j < S; j += kThreads)
    if (mk[j]) m = max(m, s[j]);
  m = block_max(m, red_max);  // its __syncthreads also covers `tab`

  long long sum = 0;
  for (int j = threadIdx.x; j < S; j += kThreads)
    if (mk[j]) sum += tab[min(max(m - s[j], 0), 255)];
  const float denom = fmaxf(__ll2float_rn(block_sum(sum, red_sum)), 1.0f);

  for (int j = threadIdx.x; j < S; j += kThreads) {
    const int e = mk[j] ? tab[min(max(m - s[j], 0), 255)] : 0;
    const float c = floorf(__fdiv_rn(__fmul_rn(__int2float_rn(e), out_scale),
                                     denom));
    out[row + j] = static_cast<int>(fminf(fmaxf(c, 0.0f), out_max));
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success).
// scores (rows, S) int32, mask (rows, S) bool bytes, table (256,) int32,
// out (rows, S) int32; out_scale = 2^out_frac_bits.
extern "C" int lut_softmax_launch(const void* scores, const void* mask,
                                  const void* table, void* out, int rows,
                                  int S, float out_scale, float out_max,
                                  void* stream) {
  if (rows == 0 || S == 0) return 0;
  lut_softmax_kernel<<<rows, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(scores), static_cast<const uint8_t*>(mask),
      static_cast<const int*>(table), static_cast<int*>(out), S, out_scale,
      out_max);
  return static_cast<int>(cudaGetLastError());
}
