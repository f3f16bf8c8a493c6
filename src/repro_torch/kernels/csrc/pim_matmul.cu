// Macro-tiled PIM matmul on Hopper (sm_90a): (M, K) int8 x (K, N) int8 ->
// (M, N) float32 on the accumulation grid, or a stack of E such products,
// (E, M, K) x (E, K, N) -> (E, M, N), in one launch (the experts of a MoE
// layer, each its own weight-stationary engine).
//
// Replaces the TPU kernel `repro/kernels/pim_matmul.py::pim_matmul_int_pallas`
// (body `_pim_matmul_kernel`, ADC `_adc`).  Ideal mode: the exact int32 dot,
// converted once to float32.  Quantized mode: every 16-row word-line group's
// int32 partial sum goes through the saturating ADC,
// code = clip(rint(fdiv_rn(psum, step)), lo, hi), and the output is
// sum(code) * step.  The ADC codes are summed in int32 and multiplied by
// `step` once, so the result does not depend on the order of the sum (the
// plain version, `kernels/pim_matmul.py`, sums the same way: kernel and
// plain agree bit for bit at every K).
//
// What bounds it on the H100: at decode (M of a few tokens) the weight
// bytes, K * N read once, over HBM; at prefill the ADC's per-group work,
// seven instructions per 16-row group and output on the CUDA cores
// (the int8 dot products themselves are a few percent of the tensor cores'
// time).
//
// Design:
// * s8 tensor cores, one word-line group per k-step.  Operands are staged
//   in shared memory as rows whose K bytes are contiguous, and fragments are
//   read with `ldmatrix` (b16 rows of 16 bytes carry int8 pairs).  Quantized
//   mode issues `mma.sync.m16n8k16.s32.s8.s8.s32` (k = 16 is exactly one
//   group) with a zero C, runs its four s32 results per thread through the
//   ADC and adds the codes into int32 registers.  Ideal mode accumulates
//   into the MMA's C across K with m16n8k32.
// * Both operands are read as stored.  At M > 16 the tokens are the A
//   operand (rows of x) and the weights the B operand (rows n of the
//   deployed (N, K) store, the K-contiguous (K, N) view that is served).  At
//   M <= 16 (decode) the two swap: the weight store is the m16 A operand and
//   the few token rows the n8 B operand, so a tile wastes at most 4 of 8
//   rows, not 12 of 16.  A row-major (n-contiguous) layer view is read byte
//   by byte and transposed into the same staging rows (correct, not fast).
// * cp.async staging: 16-byte `cp.async.cg` copies into a ring of 4-6
//   stages of 64 K bytes in dynamic shared memory, rows padded to 80 bytes
//   so that the eight rows an `ldmatrix` phase reads fall on distinct banks.
//   Rows past M or N and bytes past K are zero-filled through cp.async's
//   src-size operand (a zero group's partial sum is 0 and so is its code);
//   an operand whose rows are not 16-byte aligned is loaded byte by byte.
// * Split-K in one launch.  Few output tiles (decode; prefill at N 1024)
//   cut K into ranges of at least 256 rows, 64-row aligned, until the grid
//   holds about two CTAs per SM.  Each split writes its int32 sums; the
//   last CTA of an output tile to arrive (an atomic counter after
//   __threadfence) adds the other splits, four loads in flight at a time,
//   converts and resets the counter to 0 for the next launch.  Any order of
//   int32 additions is exact, so the result is that of one CTA.
// * An expert axis.  grid.z holds E x splits CTAs per output tile: expert
//   blockIdx.z / splits, split blockIdx.z % splits.  Each CTA moves its
//   operand and output pointers to its expert's slice and is otherwise the
//   CTA of a single product, so a stacked launch computes exactly what E
//   launches compute.  A split launch's partial sums and tile counters are
//   indexed by (expert, tile); the wrapper splits only grids of at most
//   one output tile (over all experts) per SM, so its counters suffice.
// * A division-free exact ADC.  code(p) is monotone in the integer partial
//   sum p, and |p| <= 16 * 128 * 128 = 2^18.  So it is fixed by the
//   thresholds T[c] = min{p : code(p) >= c}, c = lo + 1 .. hi, which the
//   wrapper computes once per configuration from the reference ADC
//   (`quant.adc_code`) over every p in [-2^18, 2^18].  With M = 1.5 * 2^23
//   and pm = M + p, the kernel guesses M + g = fma(sat(fma(pm, a, b)), w,
//   M + lo) in float32, where w = hi - lo, a = 1 / (step * w) and
//   b = -(M / step + lo + 1/4) / w: g is rint(p / step - 1/4) clipped to
//   [lo, hi], the code or one below it.  Then code(p) = g + (p >= T[g + 1])
//   (T[hi + 1] = +inf).  The wrapper replays this rule in the same float32
//   operations over the whole range and refuses a configuration where it
//   misses a single code (an ADC step below about 3), so the codes are
//   bit-identical to clip(rint(fdiv_rn(p, step)), lo, hi) for every
//   partial sum.  Per group and output that is: the MMA's C = 0x4B400000
//   makes its result the bits of pm (exact for |p| < 2^22); the clamp is
//   the `.sat` of the first fma; the second fma rounds to the integer
//   M + g (float32 spacing is 1 there), whose bits, times 4, address
//   M + T[g + 1] - 1 in shared memory; `sub.sat` of the two is the 0 or 1
//   of the correction, and M + g plus it is the float M + code, whose bits
//   are summed in int32 (wrapping; the M's come off at the end).  No division, conversion or compare-and-select
//   is left in the loop: an IEEE division per group, or integer clamps and
//   compares on the ALU pipe (half the FMA pipe's rate), bound it before.

#include "pim_common.cuh"

namespace {

using pim::cp_async16;
using pim::cp_async_commit;
using pim::cp_async_wait;
using pim::ldsm_x2;
using pim::ldsm_x4;
using pim::mma_k32;
using pim::smem_u32;

constexpr int kThreads = 256;
constexpr int kBK = 64;          // K bytes per stage
constexpr int kRS = kBK + 16;    // staged row stride: 5 * row mod 8 spreads banks
constexpr int kMaxTable = 256;   // ADC thresholds (adc_bits <= 8)

struct Operand {
  const int8_t* ptr;
  long ld_row;  // bytes between rows (the non-K axis)
  long ld_k;    // bytes between K positions (1: K-contiguous)
  long ld_e;    // bytes between experts
  int rows;
  int vec;      // ld_k == 1 and every row 16-byte aligned: cp.async
};

// d = A (16 x 16, row) . B (16 x 8, col) + 0x4B400000: one word-line group,
// each sum p in the bits of the float 1.5 * 2^23 + p (|p| <= 2^18)
__device__ __forceinline__ void mma_k16(int (&d)[4], uint32_t a0, uint32_t a1,
                                        uint32_t b0) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%7, %7, %7, %7};\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(a0), "r"(a1), "r"(b0), "r"(0x4B400000));
}

// The ADC's constants (see the header): s = sat(fma(pm, a, b)) and
// fma(s, w, c) = 1.5 * 2^23 + g.
struct Adc {
  float a, b, w, c;
};

// One group through the ADC: adds the bits of 1.5 * 2^23 + code to `sum`
// (int32, wrapping; the epilogue takes the 1.5 * 2^23's off).  `d` is the
// MMA's result with C = 0x4B400000, the bits of pm = 1.5 * 2^23 + p.  `tab`
// is the shared address of the table less 4 * bits(c): the threshold of the
// guess g, 1.5 * 2^23 + T[g + 1] - 1 (+inf for g = hi), sits at
// tab + 4 * bits(1.5 * 2^23 + g).
__device__ __forceinline__ void adc_group(int d, const Adc& q, uint32_t tab,
                                          int& sum) {
  const float pm = __int_as_float(d);
  float s, thr, up;
  asm("fma.rn.sat.f32 %0, %1, %2, %3;\n" : "=f"(s) : "f"(pm), "f"(q.a), "f"(q.b));
  const float gm = __fmaf_rn(s, q.w, q.c);
  asm("ld.shared.f32 %0, [%1];\n" : "=f"(thr) : "r"(__float_as_uint(gm) * 4u + tab));
  asm("sub.rn.sat.f32 %0, %1, %2;\n" : "=f"(up) : "f"(pm), "f"(thr));
  // 1.5 * 2^23 + g + up is an exact float32 integer
  sum = static_cast<int>(static_cast<uint32_t>(sum) +
                         __float_as_uint(__fadd_rn(gm, up)));
}

// 16 bytes of row `row`, K positions [k, k + 16), into `dst`, byte by byte
// (an operand that is not K-contiguous or not 16-byte aligned); bytes at or
// past k_end and rows at or past op.rows read 0.
__device__ __noinline__ void load_chunk(uint8_t* dst, Operand op,
                                        int row, int k, int k_end) {
  int avail = row < op.rows ? k_end - k : 0;
  avail = avail < 0 ? 0 : (avail > 16 ? 16 : avail);
  uint32_t v[4] = {0u, 0u, 0u, 0u};
  const int8_t* src = op.ptr + row * op.ld_row + k * op.ld_k;
#pragma unroll
  for (int i = 0; i < 16; ++i)
    if (i < avail)
      v[i >> 2] |= static_cast<uint32_t>(static_cast<uint8_t>(src[i * op.ld_k]))
                   << (8 * (i & 3));
  *reinterpret_cast<uint4*>(dst) = make_uint4(v[0], v[1], v[2], v[3]);
}

// C[i][j] = sum_k P[i][k] Q[j][k] over a BP x BQ tile (P the m16 A operand,
// Q the n8 B operand), written to out[i * sp + j * sq]; WP x WQ warps.
template <int BP, int BQ, int WP, int WQ, int STAGES, bool QUANT>
__global__ void __launch_bounds__(kThreads, 2)
pim_matmul_kernel(Operand P, Operand Q, float* __restrict__ out,
                  int* __restrict__ part, int* __restrict__ counters,
                  const float* __restrict__ table, int n_table, Adc adc,
                  long sp, long sq, long so, int K, int splits, int k_split,
                  float step) {
  static_assert(WP * WQ * 32 == kThreads, "eight warps");
  constexpr int MT = BP / WP / 16, NT = BQ / WQ / 8;
  static_assert(MT * WP * 16 == BP && NT * WQ * 8 == BQ, "warp tiling");
  static_assert(NT == 1 || NT % 2 == 0, "B fragments by x2 or x4");
  constexpr int STAGE_BYTES = (BP + BQ) * kRS;

  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ float s_tab[kMaxTable];
  __shared__ int s_last;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wp = warp / WQ, wq = warp % WQ;
  const int p0 = blockIdx.x * BP, q0 = blockIdx.y * BQ;
  // this CTA's expert and split: the operands and output of that expert
  const int expert = blockIdx.z / splits, z = blockIdx.z % splits;
  P.ptr += expert * P.ld_e;
  Q.ptr += expert * Q.ld_e;
  out += expert * so;
  const int k_begin = z * k_split;
  const int k_end = min(K, k_begin + k_split);
  const int nk = (k_end - k_begin + kBK - 1) / kBK;

  uint32_t tab = 0;
  if constexpr (QUANT) {
    for (int i = tid; i < n_table; i += kThreads) s_tab[i] = table[i];
    tab = smem_u32(s_tab) - 4u * __float_as_uint(adc.c);
  }

  // this thread's 16-byte chunks of a stage: row r of the P rows then the Q
  // rows, K offset kc; `src` is null for a row past the operand's end
  constexpr int CHUNKS = ((BP + BQ) * (kBK / 16) + kThreads - 1) / kThreads;
  const int8_t* src[CHUNKS];
  uint32_t dst[CHUNKS];
  int kc[CHUNKS];
  bool live[CHUNKS];
#pragma unroll
  for (int i = 0; i < CHUNKS; ++i) {
    const int c = tid + i * kThreads;
    const int r = c / (kBK / 16);
    live[i] = r < BP + BQ;
    kc[i] = (c % (kBK / 16)) * 16;
    dst[i] = r * kRS + kc[i];
    const Operand& op = r < BP ? P : Q;
    const int row = r < BP ? p0 + r : q0 + r - BP;
    src[i] = live[i] && row < op.rows ? op.ptr + row * op.ld_row + kc[i] : nullptr;
  }
  const bool fast = P.vec && Q.vec;
  auto load_stage = [&](int stage, int k) {
    uint8_t* base = smem + stage * STAGE_BYTES;
    if (fast) {
#pragma unroll
      for (int i = 0; i < CHUNKS; ++i) {
        if (!live[i]) continue;
        int avail = src[i] ? k_end - k - kc[i] : 0;
        avail = avail < 0 ? 0 : (avail > 16 ? 16 : avail);
        cp_async16(base + dst[i], avail ? src[i] + k : P.ptr, avail);
      }
      return;
    }
    for (int c = tid; c < (BP + BQ) * (kBK / 16); c += kThreads) {
      const int r = c / (kBK / 16), kb = (c % (kBK / 16)) * 16;
      if (r < BP)
        load_chunk(base + r * kRS + kb, P, p0 + r, k + kb, k_end);
      else
        load_chunk(base + r * kRS + kb, Q, q0 + r - BP, k + kb, k_end);
    }
  };

  // ideal: the MMA's C; quantized: the sum of bits(1.5 * 2^23 + code)
  int acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load_stage(s, k_begin + s * kBK);
    cp_async_commit();
  }

  // ldmatrix row addresses of this lane within a stage
  const int a_row = wp * MT * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_k = (lane >> 4) * 16;
  const int b_row = BP + wq * NT * 8 + (lane & 7) + (NT > 1 ? (lane >> 4) * 8 : 0);
  const int b_k = ((lane >> 3) & 1) * 16;

  for (int t = 0; t < nk; ++t) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int next = t + STAGES - 1;
    if (next < nk) load_stage(next % STAGES, k_begin + next * kBK);
    cp_async_commit();

    const uint8_t* base = smem + (t % STAGES) * STAGE_BYTES;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 32) {  // two word-line groups
      uint32_t a[MT][4], b[NT][2];
#pragma unroll
      for (int i = 0; i < MT; ++i)
        ldsm_x4(a[i], base + (a_row + i * 16) * kRS + kk + a_k);
#pragma unroll
      for (int j = 0; j < NT; j += (NT > 1 ? 2 : 1)) {
        const uint8_t* bp = base + (b_row + j * 8) * kRS + kk + b_k;
        if constexpr (NT > 1) {
          uint32_t r[4];
          ldsm_x4(r, bp);
          b[j][0] = r[0];
          b[j][1] = r[1];
          b[j + 1][0] = r[2];
          b[j + 1][1] = r[3];
        } else {
          ldsm_x2(b[j], bp);
        }
      }
      if constexpr (QUANT) {
#pragma unroll
        for (int g = 0; g < 2; ++g)
#pragma unroll
          for (int i = 0; i < MT; ++i)
#pragma unroll
            for (int j = 0; j < NT; ++j) {
              int d[4];
              mma_k16(d, a[i][2 * g], a[i][2 * g + 1], b[j][g]);
#pragma unroll
              for (int e = 0; e < 4; ++e)
                adc_group(d[e], adc, tab, acc[i][j][e]);
            }
      } else {
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int j = 0; j < NT; ++j) mma_k32(acc[i][j], a[i], b[j]);
      }
    }
  }
  cp_async_wait<0>();

  // epilogue: element (i, j) of fragment e sits at row g (+8 for e >= 2),
  // column 2 * (lane % 4) + (e & 1)
  const int gi = lane >> 2, gj = 2 * (lane & 3);
  const int groups = nk * (kBK / 16);  // ADC groups this CTA ran (int32 wrap)
  auto each = [&](auto&& fn) {
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int pi = p0 + wp * MT * 16 + i * 16 + gi + (e >= 2 ? 8 : 0);
          const int qj = q0 + wq * NT * 8 + j * 8 + gj + (e & 1);
          int v = acc[i][j][e];
          if constexpr (QUANT)
            v = static_cast<int>(static_cast<uint32_t>(v) -
                                 static_cast<uint32_t>(groups) * 0x4B400000u);
          if (pi < P.rows && qj < Q.rows) fn(v, pi * sp + qj * sq);
        }
  };
  auto finish = [&](int v) {
    const float f = __int2float_rn(v);
    return QUANT ? __fmul_rn(f, step) : f;
  };

  if (splits == 1) {
    each([&](int v, long o) { out[o] = finish(v); });
    return;
  }
  // this expert's (splits, M, N) partial sums and its tiles' counters
  const long plane = static_cast<long>(P.rows) * Q.rows;
  part += static_cast<long>(expert) * splits * plane;
  each([&](int v, long o) { part[z * plane + o] = v; });
  __threadfence();
  __syncthreads();
  const int tile = (expert * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
  if (tid == 0) s_last = atomicAdd(counters + tile, 1) == splits - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  each([&](int v, long o) {
    // the other splits' sums, four loads in flight at a time
    for (int s0 = 0; s0 < splits; s0 += 4) {
      int r[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int s = s0 + u;
        r[u] = s < splits && s != z ? __ldcg(part + s * plane + o) : 0;
      }
      v += (r[0] + r[1]) + (r[2] + r[3]);
    }
    out[o] = finish(v);
  });
  if (tid == 0) counters[tile] = 0;
}

template <int BP, int BQ, int WP, int WQ, int STAGES, bool QUANT>
cudaError_t launch(dim3 grid, cudaStream_t s, const Operand& P,
                   const Operand& Q, float* out, int* part, int* counters,
                   const float* table, int n_table, const Adc& adc, long sp,
                   long sq, long so, int K, int splits, int k_split,
                   float step) {
  constexpr int smem = STAGES * (BP + BQ) * kRS;
  auto kern = pim_matmul_kernel<BP, BQ, WP, WQ, STAGES, QUANT>;
  static cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  grid.x = (P.rows + BP - 1) / BP;
  grid.y = (Q.rows + BQ - 1) / BQ;
  kern<<<grid, kThreads, smem, s>>>(P, Q, out, part, counters, table, n_table,
                                    adc, sp, sq, so, K, splits, k_split, step);
  return cudaGetLastError();
}

template <bool QUANT>
cudaError_t dispatch(int m, int n, dim3 grid, cudaStream_t s,
                     const Operand& x, const Operand& w, float* out,
                     int* part, int* counters, const float* table,
                     int n_table, const Adc& adc, int K, int splits,
                     int k_split, float step) {
  // M <= 16: the weights are the A operand (rows n), the tokens the B
  // operand, and out[m, n] = C[n][m]
  const long so = static_cast<long>(m) * n;
  if (m <= 8)
    return launch<128, 8, 8, 1, 6, QUANT>(grid, s, w, x, out, part, counters,
                                          table, n_table, adc, 1, n, so, K,
                                          splits, k_split, step);
  if (m <= 16)
    return launch<128, 16, 8, 1, 6, QUANT>(grid, s, w, x, out, part,
                                           counters, table, n_table, adc, 1,
                                           n, so, K, splits, k_split, step);
  return launch<64, 128, 2, 4, 4, QUANT>(grid, s, x, w, out, part, counters,
                                         table, n_table, adc, n, 1, so, K,
                                         splits, k_split, step);
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success).
// `experts` products in one launch: expert e's x is (m, k) at x + e * x_e
// with rows `ldx` bytes apart, its w[k, n] at w + e * w_e + k * ldk +
// n * ldn, and its output the (m, n) plane e of `out`, (experts, m, n).
// vec_x / vec_w: the operand is K-contiguous and every row of every expert
// 16-byte aligned.  `splits` > 1 needs `part`, (experts, splits, m, n)
// int32 scratch, and `counters`, one zeroed int32 per output tile of every
// expert (left zeroed); K rows
// [s * k_split, (s + 1) * k_split) belong to split s, k_split % 64 == 0.
// Quantized mode reads the `n_table` (<= 256) thresholds of `table` and the
// constants a, b, w, c of the division-free ADC (see the header).
extern "C" int pim_matmul_launch(const void* x, const void* w, void* out,
                                 void* part, void* counters,
                                 const void* table, int n_table,
                                 int experts, int m, int n, int k, long ldx,
                                 long ldk, long ldn, long x_e, long w_e,
                                 int vec_x, int vec_w, int splits,
                                 int k_split, int quantized, float step,
                                 float a, float b, float wscale, float c,
                                 void* stream) {
  if (k_split % kBK != 0 || splits < 1 || experts < 1 ||
      static_cast<long>(experts) * splits > 65535 ||
      (splits > 1 && (part == nullptr || counters == nullptr)) ||
      (quantized && (table == nullptr || n_table < 1 || n_table > kMaxTable)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Operand xo{static_cast<const int8_t*>(x), ldx, 1, x_e, m, vec_x};
  const Operand wo{static_cast<const int8_t*>(w), ldn, ldk, w_e, n, vec_w};
  const Adc adc{a, b, wscale, c};
  const dim3 grid(1, 1, experts * splits);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* op = static_cast<float*>(out);
  int* pp = static_cast<int*>(part);
  int* cp = static_cast<int*>(counters);
  const float* tp = static_cast<const float*>(table);
  const cudaError_t err =
      quantized ? dispatch<true>(m, n, grid, s, xo, wo, op, pp, cp, tp,
                                 n_table, adc, k, splits, k_split, step)
                : dispatch<false>(m, n, grid, s, xo, wo, op, pp, cp, tp,
                                  n_table, adc, k, splits, k_split, step);
  return static_cast<int>(err);
}
