// LUT softmax (shifted mode) on Hopper (sm_90a): rows of int8 or int32
// score codes and a bool mask -> int32 Q0.<out_frac_bits> probability codes.
//
// Replaces the TPU kernel `repro/kernels/lut_softmax.py::lut_softmax_pallas`
// (body `_lut_softmax_kernel`).  Per row: m = the masked row max (the
// maximum over positions of (mask ? s : kNeg)); e = table[clip(m - s, 0,
// 255)], 0 where masked; denom = max(sum(e), 1); codes = clip(floor(e *
// 2^out_frac / denom), 0, out_max).  The 256-entry table sits in shared
// memory (the TPU's one-hot x table matmul existed only for want of a VMEM
// gather).  The sum of exps is an integer (each entry is below 2^16),
// rounded once to float32, so it does not depend on the order of the sum
// and a row may be split any way at all; the divide is IEEE (__fdiv_rn, no
// fast math), then floor, as the plain version (`kernels/lut_softmax.py`)
// does, so the two agree bit for bit.  The reference's float32 sum equals
// it while the sum stays below 2^24 (about 512 positions at the table's
// maximum).
//
// What bounds it on the H100: bytes.  Each score (1 or 4 B) and mask byte
// is read once and each code (4 B) written once; a few operations per
// element are far below the card's rate, though the IEEE divide is the
// costliest of them and sits on each row's critical path.  So each row
// stays on chip from its one read to its one write, in one of four
// regimes that the host picks (`kernels/lut_softmax.py::_plan`):
//   * warp rows: S <= 1024 and more than 8 rows an SM.  One warp per row,
//     8 rows per CTA, the row in registers (the mask as bits); the max and
//     the sum are warp shuffles.  The CTA's one barrier is the table's,
//     whose loads are in flight with the rows'.
//   * held: other rows of up to 4096 positions.  One CTA per row, a thread
//     per 4 positions (at least 2 warps), the row in registers with each
//     thread's loads all issued before the first is used; two block
//     reductions.
//   * staged: longer rows that fit in shared memory (int32 up to 46,208
//     positions, int8 up to 115,520).  One CTA of 1024 threads per row;
//     each thread stages what it loads and reads back only that, so the
//     three steps cost one global read and need no barrier between them.
//   * stream: a row too long to stage, read from global memory in each of
//     the three steps.
// Lane l of a warp takes positions 32c + l: each step of a warp is one
// coalesced load of each operand (128 bytes of int32 scores), and no lane
// idles but past the row's end (a 4-position vector a lane left 3/8 of the
// lanes' work idle at S = 160, the served rows).  A warp divides only where
// one of its lanes has a nonzero exp: masked and underflowed positions get
// code 0 without the divide.
// Operands are read in place: the scores as int8 or int32 (a template
// parameter), the mask through its own strides.  A row index maps to an
// element offset through at most four (size, stride) pairs of the
// operand's leading dims, so a mask broadcast over heads is read from its
// (B, cq, S) storage and never copied.

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kNeg = -(1 << 24);  // masked score code, as the plain version's
constexpr int kMaxDims = 4;
constexpr int kTableBytes = 1024;  // 256 int32 entries
// dynamic shared memory: table, 32 warp sums (u64), 32 warp maxima, then
// (staged rows) the scores and the mask bytes, each padded to 16 bytes
constexpr int kHeaderBytes = kTableBytes + 32 * 8 + 32 * 4;
constexpr int kRowsThreads = 256;  // most threads of a warp-rows CTA (8 warps)
constexpr int kCtaThreads = 1024;  // most threads of a staged or stream CTA
constexpr int kHeldPositions = 4;  // a held row's positions a thread

enum Regime { kRows = 0, kHeld = 1, kStaged = 2, kStream = 3 };

// Element offset of row r: dims outermost first, row-major over their sizes.
struct RowMap {
  int n;
  unsigned size[kMaxDims];
  long long stride[kMaxDims];
};

__device__ __forceinline__ long long row_offset(const RowMap& map, unsigned r) {
  long long off = 0;
#pragma unroll
  for (int d = kMaxDims - 1; d >= 0; --d) {
    if (d < map.n) {
      const unsigned q = r / map.size[d];
      off += static_cast<long long>(r - q * map.size[d]) * map.stride[d];
      r = q;
    }
  }
  return off;
}

// e of a valid position; the difference wraps as the plain version's int32 one
__device__ __forceinline__ unsigned lut_exp(const int* tab, int m, int s) {
  const int d = static_cast<int>(static_cast<unsigned>(m) - static_cast<unsigned>(s));
  return static_cast<unsigned>(tab[min(max(d, 0), 255)]);
}

__device__ __forceinline__ int prob_code(unsigned e, float denom, float out_scale,
                                         float out_max) {
  const float c = floorf(__fdiv_rn(__fmul_rn(__uint2float_rn(e), out_scale), denom));
  return static_cast<int>(fminf(fmaxf(c, 0.0f), out_max));
}

__device__ __forceinline__ int warp_max(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <typename U>
__device__ __forceinline__ U warp_sum(U v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Block reductions: each warp's result through shared memory, then every
// warp reduces those with shuffles.  The first barrier also publishes
// whatever was stored to shared memory before it.
__device__ __forceinline__ int block_max(int v, int* red) {
  const int lane = threadIdx.x & 31;
  v = warp_max(v);
  if (lane == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  return warp_max(lane < static_cast<int>(blockDim.x >> 5) ? red[lane] : INT_MIN);
}

__device__ __forceinline__ unsigned long long block_sum(unsigned long long v,
                                                        unsigned long long* red) {
  const int lane = threadIdx.x & 31;
  v = warp_sum(v);
  if (lane == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  return warp_sum(lane < static_cast<int>(blockDim.x >> 5) ? red[lane] : 0ull);
}

// Warp rows: lane l holds position 32c + l of each 32-position chunk c of
// the row (at most kChunks).
template <typename T, int kChunks>
__device__ __forceinline__ void rows_body(const T* __restrict__ scores, const RowMap& smap,
                                          const uint8_t* __restrict__ mask,
                                          const RowMap& mmap, const int* __restrict__ table,
                                          int* __restrict__ out, int rows, int S,
                                          float out_scale, float out_max,
                                          unsigned char* smem) {
  int* tab = reinterpret_cast<int*>(smem);
  const int lane = threadIdx.x & 31, chunks = (S + 31) >> 5;
  const unsigned row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const bool live = row < static_cast<unsigned>(rows);
  int v[kChunks];      // the masked score: kNeg where masked, INT_MIN past the row
  unsigned valid = 0;  // bit c: position 32c + lane is valid
  if (live) {
    const T* sp = scores + row_offset(smap, row);
    const uint8_t* mp = mask + row_offset(mmap, row);
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int j = 32 * c + lane;
      v[c] = INT_MIN;
      if (c < chunks && j < S) {
        const bool ok = __ldg(mp + j) != 0;
        const int x = __ldg(sp + j);
        v[c] = ok ? x : kNeg;
        valid |= static_cast<unsigned>(ok) << c;
      }
    }
  }
  // the table's loads, in flight with the row's; the CTA's only barrier
  for (int i = threadIdx.x; i < kTableBytes / 16; i += blockDim.x)
    reinterpret_cast<int4*>(tab)[i] = __ldg(reinterpret_cast<const int4*>(table) + i);
  __syncthreads();
  if (!live) return;

  int m = INT_MIN;
#pragma unroll
  for (int c = 0; c < kChunks; ++c)
    if (c < chunks) m = max(m, v[c]);
  m = warp_max(m);

  unsigned sum = 0;  // at most 1024 entries below 2^16 a row: exact
#pragma unroll
  for (int c = 0; c < kChunks; ++c)
    if (c < chunks) {
      v[c] = (valid >> c & 1) ? static_cast<int>(lut_exp(tab, m, v[c])) : 0;
      sum += static_cast<unsigned>(v[c]);
    }
  const float denom = fmaxf(__uint2float_rn(warp_sum(sum)), 1.0f);

  int* op = out + static_cast<long long>(row) * S;
#pragma unroll
  for (int c = 0; c < kChunks; ++c)
    if (c < chunks) {
      const int j = 32 * c + lane;
      const unsigned e = static_cast<unsigned>(v[c]);
      int code = 0;  // the divide only where some lane of the chunk has an exp
      if (__any_sync(0xffffffffu, e != 0)) code = prob_code(e, denom, out_scale, out_max);
      if (j < S) op[j] = code;
    }
}

// One CTA per row; thread t takes positions t, t + blockDim, ... in loops
// that every thread runs the same number of times.  Held rows (at most
// kHeldPositions a thread) stay in registers, each thread's loads all
// issued before the first is used; staged rows go through shared memory,
// streamed rows are read again in each step.
template <typename T, int kRegime>
__device__ __forceinline__ void cta_body(const T* __restrict__ scores, const RowMap& smap,
                                         const uint8_t* __restrict__ mask,
                                         const RowMap& mmap, const int* __restrict__ table,
                                         int* __restrict__ out, int S, float out_scale,
                                         float out_max, unsigned char* smem) {
  constexpr bool kHold = kRegime == kHeld, kStage = kRegime == kStaged;
  int* tab = reinterpret_cast<int*>(smem);
  unsigned long long* red_sum = reinterpret_cast<unsigned long long*>(smem + kTableBytes);
  int* red_max = reinterpret_cast<int*>(smem + kTableBytes + 32 * 8);
  T* st = reinterpret_cast<T*>(smem + kHeaderBytes);
  uint8_t* sm = smem + kHeaderBytes + ((static_cast<long long>(S) * sizeof(T) + 15) & ~15ll);
  const int tid = threadIdx.x, nt = blockDim.x, iters = (S + nt - 1) / nt;
  const unsigned row = blockIdx.x;
  const T* sp = scores + row_offset(smap, row);
  const uint8_t* mp = mask + row_offset(mmap, row);

  int4 t4 = make_int4(0, 0, 0, 0);  // the table's loads, in flight with the row's
  if (tid < kTableBytes / 16) t4 = __ldg(reinterpret_cast<const int4*>(table) + tid);

  int m = INT_MIN;
  int x[kHeldPositions];  // held rows: the scores, then the exps
  unsigned valid = 0;     // held rows: bit k for position tid + k * nt
  if constexpr (kHold) {
#pragma unroll
    for (int k = 0; k < kHeldPositions; ++k) {  // clamped into the row: no bound waits
      const int j = min(tid + k * nt, S - 1);
      valid |= static_cast<unsigned>(__ldg(mp + j) != 0) << k;
      x[k] = __ldg(sp + j);
    }
#pragma unroll
    for (int k = 0; k < kHeldPositions; ++k) {
      if (tid + k * nt >= S) valid &= ~(1u << k);
      else m = max(m, (valid >> k & 1) ? x[k] : kNeg);
    }
  } else {
    for (int i = 0; i < iters; ++i) {
      const int j = tid + i * nt;
      if (j < S) {
        const bool ok = __ldg(mp + j) != 0;
        const int v = __ldg(sp + j);
        if (kStage) {
          st[j] = static_cast<T>(v);
          sm[j] = ok;
        }
        m = max(m, ok ? v : kNeg);
      }
    }
  }
  if (tid < kTableBytes / 16) reinterpret_cast<int4*>(tab)[tid] = t4;
  m = block_max(m, red_max);  // its barrier also publishes the table

  // the exp of position j < S: a thread reads back only what it staged
  auto exp_at = [&](int j) -> unsigned {
    const bool ok = kStage ? sm[j] != 0 : __ldg(mp + j) != 0;
    const int v = kStage ? static_cast<int>(st[j]) : static_cast<int>(__ldg(sp + j));
    return ok ? lut_exp(tab, m, v) : 0u;
  };

  unsigned long long sum = 0;
  if constexpr (kHold) {
#pragma unroll
    for (int k = 0; k < kHeldPositions; ++k) {
      x[k] = (valid >> k & 1) ? static_cast<int>(lut_exp(tab, m, x[k])) : 0;
      sum += static_cast<unsigned>(x[k]);
    }
  } else {
    for (int i = 0; i < iters; ++i) {
      const int j = tid + i * nt;
      if (j < S) sum += exp_at(j);
    }
  }
  const float denom = fmaxf(__ull2float_rn(block_sum(sum, red_sum)), 1.0f);

  int* op = out + static_cast<long long>(row) * S;
  for (int i = 0; i < iters; ++i) {
    const int j = tid + i * nt;
    unsigned e = 0;
    if constexpr (kHold) {
#pragma unroll
      for (int k = 0; k < kHeldPositions; ++k)
        if (k == i) e = static_cast<unsigned>(x[k]);
    } else {
      if (j < S) e = exp_at(j);
    }
    int code = 0;  // the divide only where some lane of the warp has an exp
    if (__any_sync(0xffffffffu, e != 0)) code = prob_code(e, denom, out_scale, out_max);
    if (j < S) op[j] = code;
  }
}

// One kernel name for every regime, so that a profile finds each launch as
// `lut_softmax_kernel<...>`.  kChunks: the 32-position chunks a warp row's
// lane holds (0 in the other regimes).
template <typename T, int kRegime, int kChunks>
__global__ void __launch_bounds__(kRegime == kRows ? kRowsThreads : kCtaThreads)
lut_softmax_kernel(const T* __restrict__ scores, RowMap smap,
                   const uint8_t* __restrict__ mask, RowMap mmap,
                   const int* __restrict__ table, int* __restrict__ out, int rows, int S,
                   float out_scale, float out_max) {
  extern __shared__ __align__(16) unsigned char smem[];
  if constexpr (kRegime == kRows) {
    rows_body<T, kChunks>(scores, smap, mask, mmap, table, out, rows, S, out_scale,
                          out_max, smem);
  } else {
    cta_body<T, kRegime>(scores, smap, mask, mmap, table, out, S, out_scale, out_max,
                         smem);
  }
}

RowMap row_map(const long long* desc) {
  RowMap map{};
  map.n = static_cast<int>(desc[0]);
  for (int d = 0; d < map.n; ++d) {
    map.size[d] = static_cast<unsigned>(desc[1 + d]);
    map.stride[d] = desc[1 + kMaxDims + d];
  }
  return map;
}

template <typename T, int kRegime, int kChunks>
int launch(const void* scores, const RowMap& smap, const void* mask, const RowMap& mmap,
           const void* table, void* out, int rows, int S, int grid, int threads, int smem,
           float out_scale, float out_max, cudaStream_t stream) {
  auto* kernel = lut_softmax_kernel<T, kRegime, kChunks>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<grid, threads, smem, stream>>>(
      static_cast<const T*>(scores), smap, static_cast<const uint8_t*>(mask), mmap,
      static_cast<const int*>(table), static_cast<int*>(out), rows, S, out_scale, out_max);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int regime, int chunks, const void* scores, const RowMap& smap,
             const void* mask, const RowMap& mmap, const void* table, void* out, int rows,
             int S, int grid, int threads, int smem, float out_scale, float out_max,
             cudaStream_t stream) {
#define LUT_LAUNCH(R, C)                                                              \
  return launch<T, R, C>(scores, smap, mask, mmap, table, out, rows, S, grid, threads, \
                         smem, out_scale, out_max, stream)
  switch (regime * 64 + chunks) {
    case kRows * 64 + 8: LUT_LAUNCH(kRows, 8);
    case kRows * 64 + 16: LUT_LAUNCH(kRows, 16);
    case kRows * 64 + 32: LUT_LAUNCH(kRows, 32);
    case kHeld * 64: LUT_LAUNCH(kHeld, 0);
    case kStaged * 64: LUT_LAUNCH(kStaged, 0);
    case kStream * 64: LUT_LAUNCH(kStream, 0);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef LUT_LAUNCH
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success).
// scores: int8 (score_bytes 1) or int32 (4) rows of S positions at unit
// stride, row r at element offset row_offset(smap, r); mask: bool bytes,
// likewise through mmap; a map is {n, size[4], stride[4]} (dims outermost
// first). table (256,) int32; out (rows, S) int32, contiguous; out_scale =
// 2^out_frac_bits.  regime (0 warp rows, 1 held, 2 staged, 3 stream), chunks (8,
// 16 or 32 for warp rows, else 0), grid, threads and smem (dynamic bytes)
// come from the host's plan.
extern "C" int lut_softmax_launch(const void* scores, const long long* smap,
                                  const void* mask, const long long* mmap,
                                  const void* table, void* out, int rows, int S,
                                  int score_bytes, int regime, int chunks, int grid,
                                  int threads, int smem, float out_scale, float out_max,
                                  void* stream) {
  if (rows == 0 || S == 0) return 0;
  if (regime == kHeld && S > kHeldPositions * threads)
    return static_cast<int>(cudaErrorInvalidValue);
  const RowMap sm = row_map(smap), mm = row_map(mmap);
  const auto st = static_cast<cudaStream_t>(stream);
  if (score_bytes == 1)
    return dispatch<int8_t>(regime, chunks, scores, sm, mask, mm, table, out, rows, S,
                            grid, threads, smem, out_scale, out_max, st);
  if (score_bytes == 4)
    return dispatch<int>(regime, chunks, scores, sm, mask, mm, table, out, rows, S,
                         grid, threads, smem, out_scale, out_max, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
