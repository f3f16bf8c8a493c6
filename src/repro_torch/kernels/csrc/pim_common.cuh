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

// Copy an `nrows`-row tile of one head's K or V into shared memory as int8
// values.  Row r of the tile is `dhk` bytes at `src + r * stride`: the
// stride is `dhk` for a head of the dense cache, and `Hkv * dhk` for a head
// inside the rows of a page of the pool, which is read in place.  Rows at
// or past `valid` are zero.  At 4 bits (dhk == dh / 2) byte c holds code c
// in its low nibble and code c + dh / 2 in its high nibble; each code is
// mapped through the 16-entry level table, whose levels are exact int8
// values.  The wrapper guarantees dhk % 16 == 0, `stride` % 16 == 0 and a
// 16-byte aligned `src`.
//
// A decode step reads a tile once from HBM (the cache was last touched a
// step earlier, so it is not in L2), and a CTA has nothing to hide the load
// latency behind.  So at 8 bits each thread issues kLoadBatch 16-byte loads
// before it stores any: a 256-row tile of head dim 128 takes two round
// trips to memory per thread, not 32.  The shared-memory rows are padded to
// a 4-byte stride, so each 16-byte value is stored as four words.
constexpr int kLoadBatch = 4;

__device__ inline void load_kv_tile(int8_t* dst, const int8_t* __restrict__ src,
                                    int nrows, int valid, size_t stride,
                                    int dh, int dhk, const int8_t* levels) {
  const int ld = tile_ld(dh);
  if (dhk == dh) {
    const int vecs = dh / 16;
    const int total = nrows * vecs;
    for (int i0 = threadIdx.x; i0 < total; i0 += kLoadBatch * blockDim.x) {
      int4 val[kLoadBatch];
#pragma unroll
      for (int u = 0; u < kLoadBatch; ++u) {
        const int i = i0 + u * blockDim.x;
        const int r = i / vecs, c = i - r * vecs;
        val[u] = make_int4(0, 0, 0, 0);
        if (i < total && r < valid)
          val[u] = reinterpret_cast<const int4*>(src + r * stride)[c];
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
  } else {
    const int words = dhk / 4;
    const int half = dh / 2;
    for (int i = threadIdx.x; i < nrows * words; i += blockDim.x) {
      const int r = i / words, w = i - r * words;
      uint32_t lo = 0, hi = 0;
      if (r < valid) {
        const uint32_t val = reinterpret_cast<const uint32_t*>(src + r * stride)[w];
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

// The `n` per-token scales of a tile, `stride` floats apart (1 in the dense
// cache, Hkv in a page); entries at or past `valid` are zero.
__device__ inline void load_scales(float* dst, const float* __restrict__ src,
                                   int n, int valid, int stride) {
  for (int j = threadIdx.x; j < n; j += blockDim.x)
    dst[j] = j < valid ? src[(size_t)j * stride] : 0.0f;
}

// Where the tile of KV block `ki` of one head lies, in (token, head) units:
// K/V bytes start at row0 * dhk with `stride` * dhk bytes between token
// rows, scales at row0 with `stride` floats between them.  Dense: `head`
// is the flat b * Hkv + h row of the (B * Hkv, sk) planes.  Paged: `head`
// is h, and the tile is the head's column of physical page `page` of the
// (P, block_k, Hkv) pool, read in place.
struct KvTile {
  size_t row0;
  size_t stride;
  int valid;     // rows of the tile that exist
};

__device__ inline KvTile kv_tile(bool paged, int page, int head, int hkv,
                                 int k_start, int block_k, int sk) {
  if (paged) return {(size_t)page * block_k * hkv + head, (size_t)hkv, block_k};
  return {(size_t)head * sk + k_start, 1, sk - k_start};
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
