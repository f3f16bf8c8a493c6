// Device helpers shared by the PIM attention kernels (prefill and decode).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace pim {

// Masked score code.  Any real code lies in [-128, 127], so a slot holding
// kNeg is a masked one.
constexpr float kNeg = -16777216.0f;  // -(1 << 24)
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// Row stride in bytes of an int8 tile in shared memory: one extra 32-bit
// word per row, so that 32 threads reading 32 different rows at the same
// column hit 32 different banks.
__host__ __device__ inline int tile_ld(int dh) { return dh + 4; }

// clip(x, 0, 255) as a table index; x is an integral float (or huge).
__device__ inline int lut_index(float x) {
  return static_cast<int>(fminf(fmaxf(x, 0.0f), 255.0f));
}

// Copy rows [row0, row0 + nrows) of one head's K or V plane into shared
// memory as int8 values.  `src` is the head's plane: `sk` rows of `dhk`
// bytes.  At 4 bits (dhk == dh / 2) byte c holds code c in its low nibble
// and code c + dh / 2 in its high nibble; each code is mapped through the
// 16-entry level table, whose levels are exact int8 values.  Rows at or
// past `sk` are zero.
//
// A decode step reads a tile once from HBM (the cache was last touched a
// step earlier, so it is not in L2), and a CTA has nothing to hide the load
// latency behind.  So at 8 bits each thread issues kLoadBatch 16-byte loads
// before it stores any: a 256-row tile of head dim 128 takes two round
// trips to memory per thread, not 32.  The shared-memory rows are padded to
// a 4-byte stride, so each 16-byte value is stored as four words.
constexpr int kLoadBatch = 4;

__device__ inline void load_kv_tile(int8_t* dst, const int8_t* __restrict__ src,
                                    int row0, int nrows, int sk, int dh,
                                    int dhk, const int8_t* levels) {
  const int ld = tile_ld(dh);
  if (dhk == dh && dh % 16 == 0) {
    const int vecs = dh / 16;
    const int total = nrows * vecs;
    for (int i0 = threadIdx.x; i0 < total; i0 += kLoadBatch * blockDim.x) {
      int4 val[kLoadBatch];
#pragma unroll
      for (int u = 0; u < kLoadBatch; ++u) {
        const int i = i0 + u * blockDim.x;
        const int r = i / vecs, c = i - r * vecs;
        val[u] = make_int4(0, 0, 0, 0);
        if (i < total && row0 + r < sk)
          val[u] = reinterpret_cast<const int4*>(src + (size_t)(row0 + r) * dh)[c];
      }
#pragma unroll
      for (int u = 0; u < kLoadBatch; ++u) {
        const int i = i0 + u * blockDim.x;
        if (i < total) {
          const int r = i / vecs, c = i - r * vecs;
          int* d = reinterpret_cast<int*>(dst + r * ld + 16 * c);
          d[0] = val[u].x;
          d[1] = val[u].y;
          d[2] = val[u].z;
          d[3] = val[u].w;
        }
      }
    }
  } else if (dhk == dh) {
    const int words = dh / 4;
    for (int i = threadIdx.x; i < nrows * words; i += blockDim.x) {
      const int r = i / words, w = i - r * words;
      const int s = row0 + r;
      int val = 0;
      if (s < sk) val = reinterpret_cast<const int*>(src + (size_t)s * dh)[w];
      reinterpret_cast<int*>(dst + r * ld)[w] = val;
    }
  } else {
    const int words = dhk / 4;
    const int half = dh / 2;
    for (int i = threadIdx.x; i < nrows * words; i += blockDim.x) {
      const int r = i / words, w = i - r * words;
      const int s = row0 + r;
      uint32_t lo = 0, hi = 0;
      if (s < sk) {
        const uint32_t val =
            reinterpret_cast<const uint32_t*>(src + (size_t)s * dhk)[w];
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const uint32_t byte = (val >> (8 * b)) & 0xFFu;
          lo |= static_cast<uint32_t>(static_cast<uint8_t>(levels[byte & 0xFu])) << (8 * b);
          hi |= static_cast<uint32_t>(static_cast<uint8_t>(levels[byte >> 4])) << (8 * b);
        }
      }
      reinterpret_cast<uint32_t*>(dst + r * ld)[w] = lo;
      reinterpret_cast<uint32_t*>(dst + r * ld + half)[w] = hi;
    }
  }
}

// Exact int8 dot product of two shared-memory rows of `dh` values.
__device__ inline int dot_i8(const int8_t* a, const int8_t* b, int dh) {
  const int* aw = reinterpret_cast<const int*>(a);
  const int* bw = reinterpret_cast<const int*>(b);
  int acc = 0;
  for (int w = 0; w < dh / 4; ++w) acc = __dp4a(aw[w], bw[w], acc);
  return acc;
}

// The 8-bit score code of one integer dot product, with the reference's
// multiply order ((s * qs) * ks) * sm_scale and round-half-to-even.
__device__ inline float score_code(int s_int, float qs, float ks,
                                   float sm_scale, float score_scale,
                                   float qmax) {
  float s = __fmul_rn(__fmul_rn(__fmul_rn(static_cast<float>(s_int), qs), ks),
                      sm_scale);
  return fminf(fmaxf(rintf(__fdiv_rn(s, score_scale)), -qmax - 1.0f), qmax);
}

__device__ inline float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ inline float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Raise a kernel's dynamic shared memory limit once per process.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, int bytes, int* granted) {
  if (bytes <= 48 * 1024 || bytes <= *granted) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) *granted = bytes;
  return err;
}

}  // namespace pim
