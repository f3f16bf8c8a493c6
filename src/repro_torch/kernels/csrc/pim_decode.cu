// Split-K flash decode for PIM attention (Sq == 1, or k+1 verify rows) on
// Hopper (sm_90a).
//
// Replaces the TPU kernel `repro/kernels/pim_decode.py::pim_decode_pallas`
// (body `_decode_kernel`, plus the stage-2 combine the JAX wrapper runs in
// jnp).  The q heads of one KV group and the verify positions are packed as
// rows r = l * G + g, each with its own causal bound q_pos + l.  Stage 1:
// one CTA per (KV partition, b * Hkv) emits the partition's partial
// (m, den, acc) from LUT exps; a partition that cannot contribute (past
// kv_len, outside the causal / window reach of the last valid row, or a
// row with q_len 0) emits (kNeg, 0, 0) without loading anything.  Stage 2
// (`pim_decode_combine_kernel`) rescales each partition by
// table[m_glob - m_p] / 2^15, exactly 0 for a skipped partition, and
// divides by max(den, 1): the combine stays in the LUT domain.
//
// What bounds it on the H100: a decode step reads each KV head's cache once
// (int8 or packed 4-bit, plus the f32 scale planes) and does O(rows) work
// per byte, so it is bound by HBM bytes (3.35 TB/s).  The split-K grid
// gives B * Hkv * ceil(kv_len / block_k) CTAs to fill the 132 SMs; each
// tile is read from HBM once into shared memory and used by every packed
// row, so the G query heads of a group (and the verify rows) share one K/V
// read; the K/V operands are views of the cache, never copies of it.  At
// short caches the grid is small and the step is bound by the latency of
// the tile loads (which `load_kv_tile` batches) and of the launch; a
// persistent or CUDA-graph launch is the next step.
//
// Paged mode (a non-null (nb, n_kblk) int32 page table): one split-K
// partition is one page, block_k is the page size and the grid is
// (n_kblk, B * Hkv).  Partition ki of slot b reads physical page pt[b, ki]
// of the pool (P, page_size, Hkv, dhk) in place, the head's rows Hkv * dhk
// bytes apart; an unallocated entry (< 0) emits (kNeg, 0, 0) without a
// load, like a partition past kv_len, so the combine adds exact zeros and
// paged equals dense at block_k == page_size bit for bit.  Cost on this
// card: 16-token pages give 16x more CTAs than block_k 256, each loading a
// 16-row tile and writing a partial the combine reads back, so at long
// contexts the step pays per-CTA latency and partial traffic rather than
// KV bytes, and the combine walks every table entry: 0.153 ms against the
// dense 0.034 ms at kv_len 4096 (batch 4, 16/8 heads, head_dim 128, H100
// SXM at 700 W), 0.084 ms of it in the combine.  A faster design gives a
// CTA several pages of the row (combining them online in shared memory),
// prefetches the next page with cp.async, and combines only the allocated
// partitions.
//
// Exactness: every row's arithmetic depends only on its own q row, bound
// and the partition, never on how many rows are packed, so a verify row is
// bit-identical to the single-step decode at its position.  The combine
// runs the partitions in order with separately rounded multiply and add,
// the same operations as the plain PyTorch combine.

#include "pim_common.cuh"

namespace {

__global__ void __launch_bounds__(pim::kThreads)
pim_decode_kernel(const int8_t* __restrict__ q, const float* __restrict__ qs,
                  const int8_t* __restrict__ k, const float* __restrict__ ks,
                  const int8_t* __restrict__ v, const float* __restrict__ vs,
                  const int* __restrict__ scalars, int nb,
                  const int* __restrict__ pt,
                  const int* __restrict__ table, const int8_t* __restrict__ levels,
                  float* __restrict__ part_m, float* __restrict__ part_den,
                  float* __restrict__ part_acc, int* __restrict__ iters,
                  int rows, int g, int sq, int dh, int dhk, int sk, int block_k,
                  int n_kblk, int hkv_per_b, int causal, int window,
                  float sm_scale, float score_scale, float qmax) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ld = pim::tile_ld(dh);
  float* tab = reinterpret_cast<float*>(smem);        // 256
  float* ks_s = tab + 256;                            // block_k
  float* vs_s = ks_s + block_k;                       // block_k
  float* qs_s = vs_s + block_k;                       // rows
  float* e_s = qs_s + rows;                           // rows * block_k
  int8_t* q_s = reinterpret_cast<int8_t*>(e_s + rows * block_k);
  int8_t* k_s = q_s + rows * ld;
  int8_t* v_s = k_s + block_k * ld;
  int8_t* lev_s = v_s + block_k * ld;                 // 16

  const int tid = threadIdx.x;
  const int ki = blockIdx.x;
  const int bhkv = blockIdx.y;
  const int b = bhkv / hkv_per_b;
  const int q_pos = scalars[b];
  const int kv_len = scalars[nb + b];
  const int q_len = scalars[2 * nb + b];
  const int n_valid = min(q_len, sq);
  const int k_start = ki * block_k;
  // the partition gate uses the reach of the last valid row
  const int q_hi = q_pos + n_valid - 1;
  const bool paged = pt != nullptr;
  const int page = paged ? pt[(size_t)b * n_kblk + ki] : 0;
  bool needed = page >= 0 && q_len > 0 && k_start < kv_len;
  if (causal) needed = needed && k_start <= q_hi;
  if (window) needed = needed && (k_start + block_k - 1) > (q_pos - window);

  const size_t part = (size_t)bhkv * n_kblk + ki;
  float* pm = part_m + part * rows;
  float* pd = part_den + part * rows;
  float* pa = part_acc + part * rows * dh;
  if (!needed) {
    for (int r = tid; r < rows; r += blockDim.x) {
      pm[r] = pim::kNeg;
      pd[r] = 0.0f;
    }
    for (int i = tid; i < rows * dh; i += blockDim.x) pa[i] = 0.0f;
    if (tid == 0) iters[part] = 0;
    return;
  }
  if (tid == 0) iters[part] = 1;

  for (int i = tid; i < 256; i += blockDim.x) tab[i] = static_cast<float>(table[i]);
  if (tid < 16) lev_s[tid] = levels[tid];
  {
    const int words = dh / 4;
    const int* qw = reinterpret_cast<const int*>(q + (size_t)bhkv * rows * dh);
    for (int i = tid; i < rows * words; i += blockDim.x) {
      const int r = i / words, w = i - r * words;
      reinterpret_cast<int*>(q_s + r * ld)[w] = qw[i];
    }
  }
  for (int r = tid; r < rows; r += blockDim.x) qs_s[r] = qs[(size_t)bhkv * rows + r];
  __syncthreads();  // levels are in shared memory before the tile loads
  // dense: the flat b * Hkv + h row; paged: h, of hkv_per_b (== Hkv) heads
  const int head = paged ? bhkv % hkv_per_b : bhkv;
  const pim::KvTile t = pim::kv_tile(paged, page, head, hkv_per_b, k_start, block_k, sk);
  pim::load_kv_tile(k_s, k + t.row0 * dhk, block_k, t.valid, t.stride * dhk, dh, dhk, lev_s);
  pim::load_kv_tile(v_s, v + t.row0 * dhk, block_k, t.valid, t.stride * dhk, dh, dhk, lev_s);
  pim::load_scales(ks_s, ks + t.row0, block_k, t.valid, (int)t.stride);
  pim::load_scales(vs_s, vs + t.row0, block_k, t.valid, (int)t.stride);
  __syncthreads();

  // scores -> masked 8-bit codes; row r is query position q_pos + r / g
  for (int idx = tid; idx < rows * block_k; idx += blockDim.x) {
    const int r = idx / block_k, j = idx - r * block_k;
    const int l = r / g;
    const int k_pos = k_start + j;
    const int s_int = pim::dot_i8(q_s + r * ld, k_s + j * ld, dh);
    const float code = pim::score_code(s_int, qs_s[r], ks_s[j], sm_scale,
                                       score_scale, qmax);
    bool ok = k_pos < kv_len && l < n_valid;
    if (causal) ok = ok && k_pos <= q_pos + l;
    if (window) ok = ok && k_pos > q_pos + l - window;
    e_s[idx] = ok ? code : pim::kNeg;
  }
  __syncthreads();

  // partition max, exps and their sum, one warp per row
  const int warp = tid >> 5, lane = tid & 31;
  for (int r = warp; r < rows; r += pim::kWarps) {
    float* row = e_s + r * block_k;
    float mx = pim::kNeg;
    for (int j = lane; j < block_k; j += 32) mx = fmaxf(mx, row[j]);
    mx = pim::warp_max(mx);
    float sum = 0.0f;
    for (int j = lane; j < block_k; j += 32) {
      const float c = row[j];
      const float e = c == pim::kNeg ? 0.0f : tab[pim::lut_index(mx - c)];
      row[j] = e;
      sum += e;
    }
    sum = pim::warp_sum(sum);
    if (lane == 0) {
      pm[r] = mx;
      pd[r] = sum;
    }
  }
  __syncthreads();

  // acc = e . (V * v_scale)
  for (int idx = tid; idx < rows * dh; idx += blockDim.x) {
    const int r = idx / dh, d = idx - r * dh;
    const float* e_row = e_s + r * block_k;
    float acc = 0.0f;
    for (int j = 0; j < block_k; ++j)
      acc += e_row[j] * (static_cast<float>(v_s[j * ld + d]) * vs_s[j]);
    pa[idx] = acc;
  }
}

// out[bhkv, r, :] = sum_p acc_p * resc_p / max(sum_p den_p * resc_p, 1)
__global__ void __launch_bounds__(pim::kThreads)
pim_decode_combine_kernel(const float* __restrict__ part_m,
                          const float* __restrict__ part_den,
                          const float* __restrict__ part_acc,
                          const int* __restrict__ table, float* __restrict__ out,
                          int n_kblk, int rows, int dh, float table_scale) {
  const int bhkv = blockIdx.x;
  for (int idx = threadIdx.x; idx < rows * dh; idx += blockDim.x) {
    const int r = idx / dh;
    float m_glob = pim::kNeg;
    for (int p = 0; p < n_kblk; ++p)
      m_glob = fmaxf(m_glob, part_m[((size_t)bhkv * n_kblk + p) * rows + r]);
    float den = 0.0f, acc = 0.0f;
    for (int p = 0; p < n_kblk; ++p) {
      const size_t part = (size_t)bhkv * n_kblk + p;
      const float m_p = part_m[part * rows + r];
      const float rs = m_p <= pim::kNeg / 2
                           ? 0.0f
                           : static_cast<float>(table[pim::lut_index(m_glob - m_p)]) * table_scale;
      den = __fadd_rn(den, __fmul_rn(part_den[part * rows + r], rs));
      acc = __fadd_rn(acc, __fmul_rn(part_acc[part * rows * dh + idx], rs));
    }
    out[(size_t)bhkv * rows * dh + idx] = acc / fmaxf(den, 1.0f);
  }
}

int g_smem_granted = 0;

}  // namespace

extern "C" int pim_decode_smem_bytes(int rows, int block_k, int dh) {
  const int ld = pim::tile_ld(dh);
  return (256 + 2 * block_k + rows + rows * block_k) * 4 +
         (rows + 2 * block_k) * ld + 16;
}

// Stage 1: partials of every (partition, b * Hkv).  `page_table` is null for
// a dense cache; otherwise (nb, n_kblk) int32 and block_k is the page size.
// Returns cudaGetLastError().
extern "C" int pim_decode_launch(
    const void* q, const void* qs, const void* k, const void* ks,
    const void* v, const void* vs, const void* scalars, int nb,
    const void* page_table, const void* table, const void* levels,
    void* part_m, void* part_den, void* part_acc, void* iters, int bhkv, int rows, int g, int sq, int dh,
    int dhk, int sk, int block_k, int n_kblk, int hkv_per_b, int causal,
    int window, float sm_scale, float score_scale, float qmax, void* stream) {
  if (dhk % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = pim_decode_smem_bytes(rows, block_k, dh);
  cudaError_t err = pim::allow_smem(pim_decode_kernel, smem, &g_smem_granted);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(n_kblk, bhkv);
  pim_decode_kernel<<<grid, pim::kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q), static_cast<const float*>(qs),
      static_cast<const int8_t*>(k), static_cast<const float*>(ks),
      static_cast<const int8_t*>(v), static_cast<const float*>(vs),
      static_cast<const int*>(scalars), nb, static_cast<const int*>(page_table),
      static_cast<const int*>(table),
      static_cast<const int8_t*>(levels), static_cast<float*>(part_m),
      static_cast<float*>(part_den), static_cast<float*>(part_acc),
      static_cast<int*>(iters), rows, g, sq, dh, dhk, sk, block_k, n_kblk,
      hkv_per_b, causal, window, sm_scale, score_scale, qmax);
  return static_cast<int>(cudaGetLastError());
}

// Stage 2: the LUT-domain combine.  Returns cudaGetLastError().
extern "C" int pim_decode_combine_launch(const void* part_m, const void* part_den,
                                         const void* part_acc, const void* table,
                                         void* out, int bhkv, int n_kblk, int rows,
                                         int dh, float table_scale, void* stream) {
  pim_decode_combine_kernel<<<bhkv, pim::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(part_m), static_cast<const float*>(part_den),
      static_cast<const float*>(part_acc), static_cast<const int*>(table),
      static_cast<float*>(out), n_kblk, rows, dh, table_scale);
  return static_cast<int>(cudaGetLastError());
}
