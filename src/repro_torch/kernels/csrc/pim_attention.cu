// Fused flash-style PIM attention for prefill (Sq > 1) on Hopper (sm_90a).
//
// Replaces the TPU kernel `repro/kernels/pim_attention.py::pim_attention_pallas`
// (body `_attn_kernel`): int8 q . int8 K in int32, scaled by the q and k
// scales and 1/sqrt(Dh), requantized to 8-bit score codes; kv_len / causal /
// window masks; an online softmax whose exps AND rescale factors are read
// from the 256-entry Q1.15 exp table at clip(m - code, 0, 255); f32
// accumulation of e * (V * v_scale); output acc / max(den, 1).
//
// Grid: one CTA per (q block, q head).  The TPU grid's sequential KV axis is
// the loop inside the CTA; a KV block that cannot contribute (past kv_len,
// above the causal diagonal, outside the window, or a q block past q_len)
// is skipped before any load, and the CTA counts the blocks it ran.
//
// Paged mode (a non-null page table, `nb` rows of `n_kblk` int32 entries):
// block_k is the page size and KV block ki of sequence b is physical page
// pt[b, ki] of the pool (P, page_size, Hkv, dhk), read in place: the head's
// rows lie Hkv * dhk bytes apart, so the pool is never transposed or copied.
// An entry < 0 (unallocated) is skipped before any load and counts no
// iteration, even with prune off, as in the reference.  Cost on this card:
// a 16-token page is a 16-row tile, so a prefill CTA runs 16x more and
// smaller tile loads than at block_k 256, each with the same load latency
// and barriers and nothing to overlap them with: 1.64 ms against the dense
// kernel's 0.87 ms at Sq 512 (causal, batch 4, 16/8 heads, head_dim 128,
// H100 SXM at 700 W).  A faster design walks several pages per block (one
// table read per page, one barrier per block) and prefetches the next page
// with cp.async while the current one computes.
//
// What bounds it on the H100: at serving shapes the K/V bytes of each
// head group are re-read by every q block of every head of the group, and
// the e * V product runs on the CUDA cores in f32 (one multiply-add per
// score per head dim), so at long prompts it is bound by f32 operations,
// at 67 TFLOP/s, well before HBM.  The design keeps every intermediate
// (codes, exps, running max/sum, accumulator) on chip: the exp table is a
// gather from shared memory (the TPU's one-hot x table matmul existed only
// for want of a VMEM gather), the int8 score dot is __dp4a (exact), and the
// K/V tiles are padded by one word a row so the score loop reads them
// without bank conflicts.  Moving QK and PV onto the int8/bf16 tensor cores
// is the next step for speed.
//
// Exactness: score codes equal the reference bit for bit (same multiply
// order, IEEE division, rintf = round half to even).  The block sum of exps
// is a sum of integers below 2^24 and exact in any order; only the f32
// accumulation of e * V is reordered against the reference.

#include "pim_common.cuh"

namespace {

constexpr int kMaxAccPerThread = 32;  // block_q * Dh <= 32 * 256

__global__ void __launch_bounds__(pim::kThreads)
pim_attention_kernel(const int8_t* __restrict__ q, const float* __restrict__ qs,
                     const int8_t* __restrict__ k, const float* __restrict__ ks,
                     const int8_t* __restrict__ v, const float* __restrict__ vs,
                     const int* __restrict__ scalars, int nb,
                     const int* __restrict__ pt,
                     const int* __restrict__ table, const int8_t* __restrict__ levels,
                     float* __restrict__ out, int* __restrict__ iters,
                     int sq, int dh, int dhk, int sk, int block_q, int block_k,
                     int n_qblk, int n_kblk, int q_per_kv, int h_per_b,
                     int causal, int window, int prune, float sm_scale,
                     float score_scale, float qmax, float table_scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ld = pim::tile_ld(dh);
  float* tab = reinterpret_cast<float*>(smem);        // 256
  float* ks_s = tab + 256;                            // block_k
  float* vs_s = ks_s + block_k;                       // block_k
  float* qs_s = vs_s + block_k;                       // block_q
  float* m_s = qs_s + block_q;                        // block_q
  float* den_s = m_s + block_q;                       // block_q
  float* resc_s = den_s + block_q;                    // block_q
  float* e_s = resc_s + block_q;                      // block_q * block_k
  int8_t* q_s = reinterpret_cast<int8_t*>(e_s + block_q * block_k);
  int8_t* k_s = q_s + block_q * ld;
  int8_t* v_s = k_s + block_k * ld;
  int8_t* lev_s = v_s + block_k * ld;                 // 16

  const int tid = threadIdx.x;
  const int qi = blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / h_per_b;
  const int q_offset = scalars[b];
  const int kv_len = scalars[nb + b];
  const int q_len = scalars[2 * nb + b];
  // dense: the flat b * Hkv + h KV row; paged: h, of h_per_b / q_per_kv heads
  const bool paged = pt != nullptr;
  const int hkv = h_per_b / q_per_kv;
  const int head = paged ? (bh / q_per_kv) % hkv : bh / q_per_kv;

  for (int i = tid; i < 256; i += blockDim.x) tab[i] = static_cast<float>(table[i]);
  if (tid < 16) lev_s[tid] = levels[tid];
  {
    const int words = dh / 4;
    for (int i = tid; i < block_q * words; i += blockDim.x) {
      const int r = i / words, w = i - r * words;
      const int row = qi * block_q + r;
      int val = 0;
      if (row < sq) val = reinterpret_cast<const int*>(q + ((size_t)bh * sq + row) * dh)[w];
      reinterpret_cast<int*>(q_s + r * ld)[w] = val;
    }
  }
  for (int r = tid; r < block_q; r += blockDim.x) {
    const int row = qi * block_q + r;
    qs_s[r] = row < sq ? qs[(size_t)bh * sq + row] : 0.0f;
    m_s[r] = pim::kNeg;
    den_s[r] = 0.0f;
  }

  const int n_acc = block_q * dh;
  float acc[kMaxAccPerThread];
#pragma unroll
  for (int i = 0; i < kMaxAccPerThread; ++i) acc[i] = 0.0f;

  const int q_lo = q_offset + qi * block_q;
  const int q_hi = q_offset + min((qi + 1) * block_q, q_len) - 1;
  const int warp = tid >> 5, lane = tid & 31;
  int n_iter = 0;

  for (int ki = 0; ki < n_kblk; ++ki) {
    const int k_start = ki * block_k;
    const int page = paged ? pt[(size_t)b * n_kblk + ki] : 0;
    if (page < 0) continue;  // unallocated: uniform over the CTA
    bool needed = qi * block_q < q_len;
    if (prune) {
      needed = needed && k_start < kv_len;
      if (causal) needed = needed && k_start <= q_hi;
      if (window) needed = needed && (k_start + block_k - 1) > (q_lo - window);
    }
    if (!needed) continue;  // uniform over the CTA
    ++n_iter;
    __syncthreads();        // the previous block is done with the tiles
    const pim::KvTile t = pim::kv_tile(paged, page, head, hkv, k_start, block_k, sk);
    pim::load_kv_tile(k_s, k + t.row0 * dhk, block_k, t.valid, t.stride * dhk, dh, dhk, lev_s);
    pim::load_kv_tile(v_s, v + t.row0 * dhk, block_k, t.valid, t.stride * dhk, dh, dhk, lev_s);
    pim::load_scales(ks_s, ks + t.row0, block_k, t.valid, (int)t.stride);
    pim::load_scales(vs_s, vs + t.row0, block_k, t.valid, (int)t.stride);
    __syncthreads();

    // scores -> masked 8-bit codes
    for (int idx = tid; idx < block_q * block_k; idx += blockDim.x) {
      const int r = idx / block_k, j = idx - r * block_k;
      const int s_int = pim::dot_i8(q_s + r * ld, k_s + j * ld, dh);
      const float code = pim::score_code(s_int, qs_s[r], ks_s[j], sm_scale,
                                         score_scale, qmax);
      const int q_pos = q_lo + r, k_pos = k_start + j;
      bool ok = k_pos < kv_len;
      if (causal) ok = ok && k_pos <= q_pos;
      if (window) ok = ok && k_pos > q_pos - window;
      e_s[idx] = ok ? code : pim::kNeg;
    }
    __syncthreads();

    // online LUT softmax update, one warp per row
    for (int r = warp; r < block_q; r += pim::kWarps) {
      float* row = e_s + r * block_k;
      float mx = pim::kNeg;
      for (int j = lane; j < block_k; j += 32) mx = fmaxf(mx, row[j]);
      mx = pim::warp_max(mx);
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.0f;
      for (int j = lane; j < block_k; j += 32) {
        const float c = row[j];
        const float e = c == pim::kNeg ? 0.0f : tab[pim::lut_index(m_new - c)];
        row[j] = e;
        sum += e;
      }
      sum = pim::warp_sum(sum);
      if (lane == 0) {
        const float rs = m_old <= pim::kNeg / 2
                             ? 0.0f
                             : tab[pim::lut_index(m_new - m_old)] * table_scale;
        resc_s[r] = rs;
        den_s[r] = den_s[r] * rs + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * resc + e . (V * v_scale)
#pragma unroll
    for (int i = 0; i < kMaxAccPerThread; ++i) {
      const int idx = tid + i * pim::kThreads;
      if (idx < n_acc) {
        const int r = idx / dh, d = idx - r * dh;
        const float* e_row = e_s + r * block_k;
        float pv = 0.0f;
        for (int j = 0; j < block_k; ++j)
          pv += e_row[j] * (static_cast<float>(v_s[j * ld + d]) * vs_s[j]);
        acc[i] = acc[i] * resc_s[r] + pv;
      }
    }
  }

  __syncthreads();
#pragma unroll
  for (int i = 0; i < kMaxAccPerThread; ++i) {
    const int idx = tid + i * pim::kThreads;
    if (idx < n_acc) {
      const int r = idx / dh, d = idx - r * dh;
      const int row = qi * block_q + r;
      if (row < sq)
        out[((size_t)bh * sq + row) * dh + d] = acc[i] / fmaxf(den_s[r], 1.0f);
    }
  }
  if (tid == 0) iters[(size_t)bh * n_qblk + qi] = n_iter;
}

int g_smem_granted = 0;

}  // namespace

extern "C" int pim_attention_smem_bytes(int block_q, int block_k, int dh) {
  const int ld = pim::tile_ld(dh);
  return (256 + 2 * block_k + 4 * block_q + block_q * block_k) * 4 +
         (block_q + 2 * block_k) * ld + 16;
}

// Launches on `stream`; returns cudaGetLastError() (0 on success).
// `page_table` is null for a dense cache; otherwise (nb, n_kblk) int32 and
// block_k is the page size.
extern "C" int pim_attention_launch(
    const void* q, const void* qs, const void* k, const void* ks,
    const void* v, const void* vs, const void* scalars, int nb,
    const void* page_table, const void* table, const void* levels, void* out,
    void* iters, int bh,
    int sq, int dh, int dhk, int sk, int block_q, int block_k, int n_qblk,
    int n_kblk, int q_per_kv, int h_per_b, int causal, int window, int prune,
    float sm_scale, float score_scale, float qmax, float table_scale,
    void* stream) {
  if (block_q * dh > kMaxAccPerThread * pim::kThreads || dhk % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = pim_attention_smem_bytes(block_q, block_k, dh);
  cudaError_t err = pim::allow_smem(pim_attention_kernel, smem, &g_smem_granted);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(n_qblk, bh);
  pim_attention_kernel<<<grid, pim::kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q), static_cast<const float*>(qs),
      static_cast<const int8_t*>(k), static_cast<const float*>(ks),
      static_cast<const int8_t*>(v), static_cast<const float*>(vs),
      static_cast<const int*>(scalars), nb, static_cast<const int*>(page_table),
      static_cast<const int*>(table),
      static_cast<const int8_t*>(levels), static_cast<float*>(out),
      static_cast<int*>(iters), sq, dh, dhk, sk, block_q, block_k, n_qblk,
      n_kblk, q_per_kv, h_per_b, causal, window, prune, sm_scale, score_scale,
      qmax, table_scale);
  return static_cast<int>(cudaGetLastError());
}
