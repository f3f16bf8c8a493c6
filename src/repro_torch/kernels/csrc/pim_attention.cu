// Fused flash-style PIM attention for prefill (Sq > 1) on Hopper (sm_90a).
//
// Replaces the TPU kernel `repro/kernels/pim_attention.py::pim_attention_pallas`
// (body `_attn_kernel`): int8 q . int8 K in int32, scaled by the q and k
// scales and 1/sqrt(Dh), requantized to 8-bit score codes; kv_len / causal /
// window masks; an online softmax whose exps AND rescale factors are read
// from the 256-entry Q1.15 exp table at clip(m - code, 0, 255); f32
// accumulation of e * (V * v_scale); output acc / max(den, 1).
//
// Paged mode (a non-null page table, `nb` rows of `n_kblk` int32 entries):
// block_k is the page size and KV block ki of sequence b is physical page
// pt[b, ki] of the pool (P, page_size, Hkv, dhk), read in place: the head's
// rows lie Hkv * dhk bytes apart, so the pool is never transposed or copied.
// An entry < 0 (unallocated) is skipped before any load and counts no
// iteration, even with prune off, as in the reference.
//
// What bounds it on the H100: at long prompts the e * (V * v_scale) product,
// one float32 multiply-add per score and head dim on the CUDA cores (67
// TFLOP/s), far above the int8 scores on the tensor cores and the K/V bytes;
// at the served prompts (a few 64-row tiles per CTA) the latency of each
// tile's load and of the barriers between the phases of a tile.  Measured
// on an NVIDIA H100 80GB HBM3 at 700 W (dense Sq 512, causal, batch 4, 16/8
// heads, Dh 128; tools/ablate_attention.py): 0.18 ms against a 0.033 ms
// bound, of which the PV loop 67 us, the exps 24, the score division 19,
// V * v_scale 10, codes, masks and maxima 15, the K/V loads 14, the rest
// of the stage loop (barriers, the walk, the online steps) 21 and the
// set-up and output 12: past the PV loop, one CTA's chain of latencies
// (two CTAs an SM, four barriers a 64-row K/V pair) sets the time.
//
// Design:
// * One CTA per (reference q block, KV head): the q_per_kv heads of a group
//   are stacked as MMA rows (2 x 32 = 64 rows for internlm2-1.8b), padded to
//   16 / 32 / 64 / 128, so each K/V tile is loaded once per group.  A group
//   whose rows times head dims pass 8192 (32 float32 accumulators a thread)
//   is split over CTAs (`launch_plan` in kernels/pim_attention.py).  The q
//   extent is one reference q block, so the block early-outs and iteration
//   counts are the reference's, written for every head of the CTA.  A q
//   block past q_len (the idle rows of a ragged wave) writes its zeros and
//   exits before the set-up.
// * Head dim 256 (gemma-7b, recurrentgemma-9b): a CTA holds at most 32 rows
//   (one head's 32-row q block), in 146,064 bytes of shared memory, so one
//   CTA takes an SM (no register cap from a second one); a group of 16 q
//   heads over one KV head (recurrentgemma-9b) takes 16 CTAs, each staging
//   the group's K/V again.
// * Head dim 96 (phi-3-vision-4.2b): three k32 MMA steps; a thread's PV
//   tile is rows / 16 rows x 6 head dims, three float2 groups 32 dims apart
//   (each V load feeds rows / 16 rows: fewer shared bytes a multiply-add
//   than a 12-dim float4 tile, which was slower, tools/ablate_dh96_tile.py).
//   A K/V slot row is 112 bytes (28 words): the eight 16-byte rows of an
//   ldmatrix fall on words 0, 28, 24, ..., 4 mod 32, no bank conflict.
//   4-bit rows are 48 bytes, unpacked into the levels of codes c and c + 48.
// * Scores on s8 tensor cores: mma.sync m16n8k32, Q fragments in registers
//   for the whole CTA, K fragments by ldmatrix from a staged tile; each
//   warp owns one m16 tile and 8 / (rows / 16) n8 tiles of a 64-row stage.
// * The KV sequence is walked in units of max(block_k, 64) rows: one dense
//   256-row block (four 64-row stages), or four 16-token pages (one stage).
//   A unit loads its K stages, then its V stages, each by 16-byte
//   `cp.async.cg` copies into a 3-slot ring, two stages ahead of the one
//   being computed (4-bit KV is decoded to int8 levels by synchronous loads
//   into the same ring).  Three slots, not four, keep a dense CTA at 112 KB
//   of shared memory, so that two CTAs (16 warps) share an SM
//   (tools/ablate_attention.py times the four-slot build beside it).  Rows past the cache, of unallocated pages or of
//   pruned pages are zero-filled through cp.async's src-size.  A 64-row
//   stage of a needed block that is masked for every row of the CTA (past
//   kv_len, above the diagonal, out of the window) is not loaded at all: its
//   codes would all be masked, so it adds nothing to any max or sum.
// * K stage: int8 scores -> masked codes (int16, in shared memory for the
//   unit) and each block's row maxima (quad shuffles, then a shared atomic
//   max across the warps that share rows).  Codes, maxima and table indices
//   stay integers, with no conversion instruction on the way: the MMA's
//   C = the bits of 1.5 * 2^23 hands each int32 sum over as a float with
//   one add, and rint is one add of 1.5 * 2^23 (`pim::score_code_int`).  First V stage of a unit: one
//   thread per row takes the unit's blocks in order (the online step,
//   m_new = max(m, block max), r = table[m_new - m] / 2^15, 0 while m is
//   unset), and folds the previous unit's sums into den.  Every V stage:
//   V * v_scale formed once per element into float32 shared memory (the
//   int8 -> float by a byte permute and one add);
//   e = table[m_new - code] (0 where masked) into shared memory, its row sums
//   per block by shared atomics; then acc = acc * r + e . (V * v_scale),
//   block by block, each thread owning a tile of rows x head dims (4 x 8 at
//   64 rows and Dh 128) and reading e and V * v_scale once per j for it.
//
// Exactness: score codes equal the reference bit for bit (same multiply
// order, IEEE division, round half to even).  The online step is
// taken once per reference block, in order, so the running max, the exps and
// the rescale factors are the reference's bit for bit (a rescale by
// table[a] then table[b] is not one by table[a + b], so blocks staged
// together are never merged into one step).  den = den * r + sum(e) with
// both roundings of the reference (sum(e) is a sum of integers below 2^24,
// exact in any order).  Only the float32 sum acc * r + sum_j e_j * vv_j is
// taken in another order than the reference's acc * r + (sum_j e_j * vv_j).
// A skipped stage adds exact zeros, and a needed block with every score
// masked rescales by exactly 1 (or 0 before the first code), so pruned ==
// unpruned and paged == dense at block_k == page_size bit for bit.

#include "pim_common.cuh"

namespace {

constexpr int kKvRows = 64;              // KV rows per stage
constexpr int kStages = 3;               // cp.async ring slots
constexpr short kMasked = -32768;        // the int16 code of a masked score
constexpr int kNegInt = -(1 << 24);      // pim::kNeg as an int

__host__ __device__ constexpr int slot_ld(int dh) { return dh + 16; }
__host__ __device__ constexpr int slot_bytes(int dh) {
  return kKvRows * slot_ld(dh) + kKvRows * 4;
}
__host__ __device__ constexpr int align16(int x) { return (x + 15) & ~15; }

// Byte offsets of the dynamic shared memory, for `rows` MMA rows, head dim
// `dh` and block_k `bk`; kernels/pim_attention.py::launch_plan repeats the
// total.
struct Layout {
  int tab, qs, m, den, bmax, mblk, rblk, esum, codes, e, vv, ring, lev, total;
};

__host__ __device__ inline Layout layout(int rows, int dh, int bk) {
  const int unit = bk > kKvRows ? bk : kKvRows;
  const int nbu = bk >= kKvRows ? 1 : kKvRows / bk;
  Layout L;
  int o = 0;
  L.tab = o;   o += 256 * 4;               // exp table, float
  L.qs = o;    o += rows * 4;              // q scales
  L.m = o;     o += rows * 4;              // running max (int)
  L.den = o;   o += rows * 4;              // running denominator
  L.bmax = o;  o += nbu * rows * 4;        // block row maxima (int)
  L.mblk = o;  o += nbu * rows * 4;        // m after each block's step (int)
  L.rblk = o;  o += nbu * rows * 4;        // each block's rescale factor
  L.esum = o;  o += nbu * rows * 4;        // each block's sum of exps
  L.codes = o; o += align16(unit * (rows + 2) * 2);  // int16 codes [j][row]
  L.e = o;     o += kKvRows * rows * 4;    // exps of a stage [j][row]
  L.vv = o;    o += kKvRows * dh * 4;      // V * v_scale of a stage; Q staging
  L.ring = o;  o += kStages * slot_bytes(dh);
  L.lev = o;   o += 16;                    // 4-bit levels
  L.total = o;
  return L;
}

struct Args {
  const int8_t* q;
  const float* qs;
  const int8_t* k;
  const float* ks;
  const int8_t* v;
  const float* vs;
  const int* scalars;   // (3, nb): q_offset, kv_len, q_len
  const int* pt;        // (nb, n_kblk) page table, or null (dense)
  const int* table;
  const int8_t* levels;
  float* out;
  int* iters;
  int nb, sq, dhk, sk, bq, bk, n_qblk, n_kblk, q_per_kv, h_per_b, hpc, splits;
  int causal, window, prune;
  float sm_scale, score_scale, qmax, table_scale;
};

// The next stage to load or compute: stage c of unit u, its K (kind 0) or
// V (kind 1) rows.  Stages c_lo..c_hi of the unit are computed; `mask` has
// bit i set for each needed reference block i of the unit.
struct Cursor {
  int u, c, kind, c_lo, c_hi;
  unsigned mask;
  bool ok;
};

template <int N>
__device__ __forceinline__ void lds(float (&d)[N], const float* p) {
  static_assert(N == 1 || N == 2 || N == 4, "one vector load");
  if constexpr (N == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    d[0] = x.x; d[1] = x.y; d[2] = x.z; d[3] = x.w;
  } else if constexpr (N == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    d[0] = x.x; d[1] = x.y;
  } else {
    d[0] = *p;
  }
}

template <int N>
__device__ __forceinline__ void stg(float* p, const float (&d)[N]) {
  static_assert(N == 1 || N == 2 || N == 4, "one vector store");
  if constexpr (N == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(d[0], d[1], d[2], d[3]);
  } else if constexpr (N == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(d[0], d[1]);
  } else {
    *p = d[0];
  }
}

// Two CTAs an SM where two fit (head_dim up to 128, and 96); at head_dim 256 a
// CTA's shared memory leaves room for one, and so its registers may too.
template <int DH, int R>
__global__ void __launch_bounds__(pim::kThreads, DH > 128 ? 1 : 2)
pim_attention_kernel(const Args a) {
  constexpr int MT = R / 16;                 // m16 tiles of the CTA
  constexpr int NT = MT;                     // n8 tiles of a stage per warp
  constexpr int KS = DH / 32;                // k32 steps
  constexpr int ACC = R * DH / pim::kThreads;
  constexpr int NG = DH % 3 == 0 ? 3 : (ACC >= 32 ? 2 : 1);  // vector groups, DH / NG apart
  // dims per vector load: float2s at head_dim 96 (a 12-dim float4 tile took
  // 1.36x the time at phi-3's prefill shape on an H100 80GB HBM3 at 700 W,
  // tools/ablate_dh96_tile.py)
  constexpr int TG = DH % 3 == 0 ? 2 : (ACC / NG >= 4 ? 4 : ACC / NG);
  constexpr int TD = NG * TG;                // head dims a thread
  constexpr int TR = ACC / TD;               // rows a thread
  constexpr int TDN = DH / TD;               // threads along the head dims
  constexpr int LD = slot_ld(DH);
  constexpr int CR = R + 2;                  // code row stride (spreads banks)
  static_assert(MT >= 1 && MT <= 8 && (8 % MT) == 0, "16..128 rows");
  static_assert(TR * TD == ACC && (R / TR) * TDN == pim::kThreads && TG * TDN * NG == DH,
                "PV tiling");

  extern __shared__ __align__(16) unsigned char smem[];
  const int bk = a.bk;
  const Layout L = layout(R, DH, bk);
  float* tab = reinterpret_cast<float*>(smem + L.tab);
  float* qs_s = reinterpret_cast<float*>(smem + L.qs);
  int* m_s = reinterpret_cast<int*>(smem + L.m);
  float* den_s = reinterpret_cast<float*>(smem + L.den);
  int* bmax = reinterpret_cast<int*>(smem + L.bmax);
  int* mblk = reinterpret_cast<int*>(smem + L.mblk);
  float* rblk = reinterpret_cast<float*>(smem + L.rblk);
  float* esum = reinterpret_cast<float*>(smem + L.esum);
  short* codes = reinterpret_cast<short*>(smem + L.codes);
  float* e_s = reinterpret_cast<float*>(smem + L.e);
  float* vv = reinterpret_cast<float*>(smem + L.vv);
  int8_t* ring = reinterpret_cast<int8_t*>(smem + L.ring);
  int8_t* lev_s = reinterpret_cast<int8_t*>(smem + L.lev);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int qi = blockIdx.x;
  const int gidx = blockIdx.y / a.splits;    // KV group: bh / q_per_kv
  const int bh0 = gidx * a.q_per_kv + (blockIdx.y % a.splits) * a.hpc;
  const int b = bh0 / a.h_per_b;
  const int q_offset = a.scalars[b];
  const int kv_len = a.scalars[a.nb + b];
  const int q_len = a.scalars[2 * a.nb + b];
  const bool paged = a.pt != nullptr;
  const int hkv = a.h_per_b / a.q_per_kv;
  // dense: the flat b * Hkv + h KV row; paged: h, inside each page row
  const int head = paged ? gidx % hkv : gidx;
  const int bq = a.bq;
  const int q_lo = q_offset + qi * bq;
  const int q_hi = q_offset + min((qi + 1) * bq, q_len) - 1;
  const bool live = qi * bq < q_len;
  const int nbu = bk >= kKvRows ? 1 : kKvRows / bk;     // blocks per unit
  const int unit = bk > kKvRows ? bk : kKvRows;          // KV rows per unit
  const int n_units = (a.n_kblk + nbu - 1) / nbu;
  const int sh = bk < kKvRows ? __ffs(bk) - 1 : 0;       // log2 of a short block

  if (!live) {  // a q block past q_len runs no KV block: zeros, 0 iterations
    for (int i = tid; i < a.hpc * bq * (DH / 4); i += pim::kThreads) {
      const int r = i / (DH / 4), w = i - r * (DH / 4);
      const int hh = r / bq, row = qi * bq + r - hh * bq;
      if (row < a.sq)
        *reinterpret_cast<float4*>(a.out + ((size_t)(bh0 + hh) * a.sq + row) * DH + 4 * w) =
            make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
    if (tid < a.hpc) a.iters[(size_t)(bh0 + tid) * a.n_qblk + qi] = 0;
    return;
  }

  // ---- set-up: table, levels, row state, Q fragments ----------------------
  // (every global read is issued before the first store, so that a CTA
  // waits for memory once here)
  static_assert(pim::kThreads == 256, "one table entry a thread");
  int8_t* q_s = reinterpret_cast<int8_t*>(vv);  // Q staging, before any V
  for (int i = tid; i < R * (DH / 16); i += pim::kThreads) {
    const int r = i / (DH / 16), c = i - r * (DH / 16);
    const int hh = r / bq, row = qi * bq + r - hh * bq;
    const bool ok = hh < a.hpc && row < a.sq;
    pim::cp_async16(q_s + r * LD + 16 * c,
                    ok ? a.q + ((size_t)(bh0 + hh) * a.sq + row) * DH + 16 * c : a.q,
                    ok ? 16 : 0);
  }
  pim::cp_async_commit();
  const int tab_v = a.table[tid];
  const int8_t lev_v = tid < 16 ? a.levels[tid] : 0;
  float qs_v = 0.0f;
  if (tid < R) {
    const int hh = tid / bq, row = qi * bq + tid - hh * bq;
    if (hh < a.hpc && row < a.sq) qs_v = a.qs[(size_t)(bh0 + hh) * a.sq + row];
  }
  tab[tid] = static_cast<float>(tab_v);
  if (tid < 16) lev_s[tid] = lev_v;
  if (tid < R) {
    qs_s[tid] = qs_v;
    m_s[tid] = kNegInt;
    den_s[tid] = 0.0f;
  }
  for (int i = tid; i < nbu * R; i += pim::kThreads) {
    bmax[i] = kNegInt;
    esum[i] = 0.0f;
  }
  pim::cp_async_wait<0>();
  __syncthreads();
  const int mt = warp % MT, wn = warp / MT;  // this warp's m16 tile, n8 group
  uint32_t qa[KS][4];
  {
    const int a_row = mt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
    const int a_k = (lane >> 4) * 16;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) pim::ldsm_x4(qa[kk], q_s + a_row * LD + kk * 32 + a_k);
  }
  __syncthreads();  // the staging area is V * v_scale's from here on

  // ---- the walk over units and stages -------------------------------------
  auto unit_mask = [&](int u) {
    unsigned mask = 0;
    for (int i = 0; i < nbu; ++i) {
      const int ki = u * nbu + i;
      if (ki >= a.n_kblk) break;
      if (paged && a.pt[(size_t)b * a.n_kblk + ki] < 0) continue;
      bool needed = true;
      if (a.prune) {
        const int k_start = ki * bk;
        needed = needed && k_start < kv_len;
        if (a.causal) needed = needed && k_start <= q_hi;
        if (a.window) needed = needed && (k_start + bk - 1) > (q_lo - a.window);
      }
      if (needed) mask |= 1u << i;
    }
    return mask;
  };
  // can any score of the 64 rows from k0 be unmasked for a row of this CTA?
  auto stage_live = [&](int k0) {
    bool ok = k0 < kv_len;
    if (a.causal) ok = ok && k0 <= q_lo + bq - 1;
    if (a.window) ok = ok && k0 + kKvRows - 1 > q_lo - a.window;
    return ok;
  };
  // moves `cu` to the first unit from u on with a stage to compute; adds
  // the needed blocks of every unit it passes to *count
  auto seek = [&](Cursor& cu, int u, int* count) {
    for (; u < n_units; ++u) {
      const unsigned mask = unit_mask(u);
      if (count) *count += __popc(mask);
      if (!mask) continue;
      int lo = 0, hi = 0;
      if (bk >= kKvRows) {  // one block: skip its stages masked everywhere
        lo = bk / kKvRows;
        hi = -1;
        for (int c = 0; c < bk / kKvRows; ++c)
          if (stage_live(u * bk + c * kKvRows)) {
            lo = min(lo, c);
            hi = c;
          }
        if (hi < lo) continue;  // every score masked: r = 1 (or 0), e = 0
      }
      cu = Cursor{u, lo, 0, lo, hi, mask, true};
      return;
    }
    cu.ok = false;
  };
  auto advance = [&](Cursor& cu, int* count) {
    if (cu.c < cu.c_hi) {
      ++cu.c;
    } else if (cu.kind == 0) {
      cu.kind = 1;
      cu.c = cu.c_lo;
    } else {
      seek(cu, cu.u + 1, count);
    }
  };
  // (token, head) index of row j of the stage at `cu`, or -1 (zeros)
  auto row_of = [&](const Cursor& cu, int j) -> long {
    int ki, jb;  // the row's block and its row in the block
    if (bk >= kKvRows) {
      ki = cu.u;
      jb = cu.c * kKvRows + j;
    } else {
      ki = cu.u * nbu + (j >> sh);
      jb = j & (bk - 1);
    }
    if (!paged) {
      const int pos = ki * bk + jb;
      return pos < a.sk ? (long)head * a.sk + pos : -1L;
    }
    if (ki >= a.n_kblk) return -1L;
    const int page = a.pt[(size_t)b * a.n_kblk + ki];
    return page < 0 ? -1L : ((long)page * bk + jb) * hkv + head;
  };
  auto issue = [&](const Cursor& cu, int slot) {
    int8_t* dst = ring + slot * slot_bytes(DH);
    float* dsc = reinterpret_cast<float*>(dst + kKvRows * LD);
    const int8_t* src = cu.kind ? a.v : a.k;
    const float* ssrc = cu.kind ? a.vs : a.ks;
    if (a.dhk == DH) {
      constexpr int V = DH / 16;
      for (int i = tid; i < kKvRows * V; i += pim::kThreads) {
        const int j = i / V, c = i - j * V;
        const long row = row_of(cu, j);
        pim::cp_async16(dst + j * LD + 16 * c, row < 0 ? src : src + row * DH + 16 * c,
                        row < 0 ? 0 : 16);
      }
    } else {  // 4 bits: byte c holds code c (low nibble) and c + DH / 2
      const int words = a.dhk / 4;
      for (int i = tid; i < kKvRows * words; i += pim::kThreads) {
        const int j = i / words, w = i - j * words;
        const long row = row_of(cu, j);
        uint32_t lo = 0, hi = 0;
        if (row >= 0) {
          const uint32_t val = reinterpret_cast<const uint32_t*>(src + row * a.dhk)[w];
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            const uint32_t byte = (val >> (8 * x)) & 0xFFu;
            lo |= static_cast<uint32_t>(static_cast<uint8_t>(lev_s[byte & 0xFu])) << (8 * x);
            hi |= static_cast<uint32_t>(static_cast<uint8_t>(lev_s[byte >> 4])) << (8 * x);
          }
        }
        *reinterpret_cast<uint32_t*>(dst + j * LD + 4 * w) = lo;
        *reinterpret_cast<uint32_t*>(dst + j * LD + DH / 2 + 4 * w) = hi;
      }
    }
    if (tid < kKvRows) {
      const long row = row_of(cu, tid);
      pim::cp_async4(dsc + tid, row < 0 ? ssrc : ssrc + row, row < 0 ? 0 : 4);
    }
  };

  // PV tile of this thread: rows r0.., head dims h * (DH / NG) + TG * td + i
  const int td = tid % TDN, r0 = (tid / TDN) * TR;
  float acc[TR][TD];
#pragma unroll
  for (int i = 0; i < TR; ++i)
#pragma unroll
    for (int d = 0; d < TD; ++d) acc[i][d] = 0.0f;

  // K stages: this thread's MMA rows and their absolute q positions
  const int g = lane >> 2, qd = lane & 3;
  const int r_lo = mt * 16 + g, r_hi = r_lo + 8;
  const int qp_lo = q_lo + r_lo % bq, qp_hi = q_lo + r_hi % bq;
  const int b_row = (lane & 7) + (NT > 1 ? (lane >> 4) * 8 : 0);
  const int b_k = ((lane >> 3) & 1) * 16;

  int n_iter = 0;  // needed blocks: the reference's iteration count
  Cursor pc, cc;
  seek(pc, 0, &n_iter);
  cc = pc;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (pc.ok) {
      issue(pc, s);
      advance(pc, nullptr);
    }
    pim::cp_async_commit();
  }
  unsigned pending = 0;  // blocks of the last unit whose sums den has not taken
  for (int n = 0; cc.ok; ++n) {
    pim::cp_async_wait<kStages - 2>();
    __syncthreads();  // stage n landed; stage n - 1 is no longer read
    if (pc.ok) {
      issue(pc, (n + kStages - 1) % kStages);
      advance(pc, nullptr);
    }
    pim::cp_async_commit();
    const int8_t* tile = ring + (n % kStages) * slot_bytes(DH);
    const float* tsc = reinterpret_cast<const float*>(tile + kKvRows * LD);
    const int k0 = cc.u * unit + cc.c * kKvRows;
    const int jj0 = cc.c * kKvRows;  // the stage's first row in the unit

    if (cc.kind == 0) {
      // ---- scores -> masked codes and block row maxima ---------------------
      // C = the bits of 1.5 * 2^23: the int32 sums land in the bits of the
      // float 1.5 * 2^23 + s_int (|s_int| <= 2^21), read with one add
      int s[NT][4];
#pragma unroll
      for (int t = 0; t < NT; ++t) s[t][0] = s[t][1] = s[t][2] = s[t][3] = 0x4B400000;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t bf[NT][2];
#pragma unroll
        for (int t = 0; t < NT; t += (NT > 1 ? 2 : 1)) {
          const int8_t* bp = tile + ((wn * NT + t) * 8 + b_row) * LD + kk * 32 + b_k;
          if constexpr (NT > 1) {
            uint32_t x[4];
            pim::ldsm_x4(x, bp);
            bf[t][0] = x[0];
            bf[t][1] = x[1];
            bf[t + 1][0] = x[2];
            bf[t + 1][1] = x[3];
          } else {
            pim::ldsm_x2(bf[t], bp);
          }
        }
#pragma unroll
        for (int t = 0; t < NT; ++t) pim::mma_k32(s[t], qa[kk], bf[t]);
      }
      const float qs_lo = qs_s[r_lo], qs_hi = qs_s[r_hi];
      const int qmax = static_cast<int>(a.qmax);
      int mx_lo = kNegInt, mx_hi = kNegInt;
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        const int col8 = (wn * NT + t) * 8;
        const int blk = bk >= kKvRows ? 0 : col8 >> sh;
        const bool blk_ok = (cc.mask >> blk) & 1u;
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int col = col8 + 2 * qd + (x & 1);
          const bool hi = x >= 2;
          const int pos = k0 + col, qp = hi ? qp_hi : qp_lo;
          bool ok = blk_ok && pos < kv_len;
          if (a.causal) ok = ok && pos <= qp;
          if (a.window) ok = ok && pos > qp - a.window;
          // computed for masked scores too: no branch between the elements
          const int c = pim::score_code_int(
              __fadd_rn(__int_as_float(s[t][x]), -12582912.0f), hi ? qs_hi : qs_lo,
              tsc[col], a.sm_scale, a.score_scale, qmax);
          const int cm = ok ? c : kNegInt;
          if (hi) mx_hi = max(mx_hi, cm);
          else mx_lo = max(mx_lo, cm);
          codes[(jj0 + col) * CR + (hi ? r_hi : r_lo)] = ok ? static_cast<short>(c) : kMasked;
        }
        // the block's last n8 tile of this warp: reduce over the quad
        if (t == NT - 1 || (bk < kKvRows && (col8 + 8) >> sh != blk)) {
#pragma unroll
          for (int o = 1; o <= 2; o <<= 1) {
            mx_lo = max(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, o));
            mx_hi = max(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, o));
          }
          if (qd == 0) {
            if (mx_lo > kNegInt) atomicMax(bmax + blk * R + r_lo, mx_lo);
            if (mx_hi > kNegInt) atomicMax(bmax + blk * R + r_hi, mx_hi);
          }
          mx_lo = mx_hi = kNegInt;
        }
      }
    } else {
      // ---- the unit's online steps, at its first V stage -------------------
      const bool first = cc.c == cc.c_lo;
      if (first && tid < R) {
        const int r = tid;
        float den = den_s[r];
        for (int i = 0; i < nbu; ++i)
          if ((pending >> i) & 1u) {
            den = __fadd_rn(__fmul_rn(den, rblk[i * R + r]), esum[i * R + r]);
            esum[i * R + r] = 0.0f;
          }
        den_s[r] = den;
        int m = m_s[r];  // codes and maxima are integers: exact as ints
        for (int i = 0; i < nbu; ++i)
          if ((cc.mask >> i) & 1u) {
            const int m_new = max(m, bmax[i * R + r]);
            bmax[i * R + r] = kNegInt;
            rblk[i * R + r] = m <= kNegInt / 2
                                  ? 0.0f
                                  : __fmul_rn(tab[min(m_new - m, 255)], a.table_scale);
            mblk[i * R + r] = m_new;
            m = m_new;
          }
        m_s[r] = m;
      }
      if (first) pending = cc.mask;
      // V * v_scale, once per element
      for (int i = tid; i < kKvRows * DH / 4; i += pim::kThreads) {
        const int j = i / (DH / 4), w = i - j * (DH / 4);
        // int8 v -> float: the bits 0x4B0000 | (v + 128) are 2^23 + v + 128
        const uint32_t word =
            *reinterpret_cast<const uint32_t*>(tile + j * LD + 4 * w) ^ 0x80808080u;
        const float sc = tsc[j];
        auto val = [&](unsigned sel) {
          return __fadd_rn(__uint_as_float(__byte_perm(word, 0x4B000000u, sel)), -8388736.0f);
        };
        float4 f;
        f.x = __fmul_rn(val(0x7440), sc);
        f.y = __fmul_rn(val(0x7441), sc);
        f.z = __fmul_rn(val(0x7442), sc);
        f.w = __fmul_rn(val(0x7443), sc);
        *reinterpret_cast<float4*>(vv + j * DH + 4 * w) = f;
      }
      __syncthreads();
      // exps of the stage and their per-block row sums (integers < 2^24:
      // exact in any order): row r, JN consecutive rows j of the stage
      {
        constexpr int JN = kKvRows * R / pim::kThreads;
        const int r = tid % R, jb = (tid / R) * JN;
        const int seg = bk < JN ? bk : JN;  // stays in one block
        for (int j0 = jb; j0 < jb + JN; j0 += seg) {
          const int blk = bk >= kKvRows ? 0 : j0 >> sh;
          const int mb = mblk[blk * R + r];
          float part[2] = {0.0f, 0.0f};
#pragma unroll 8
          for (int j = j0; j < j0 + seg; ++j) {
            const short c = codes[(jj0 + j) * CR + r];
            const float e = c == kMasked ? 0.0f : tab[min(max(mb - c, 0), 255)];
            e_s[j * R + r] = e;
            part[j & 1] += e;
          }
          const float sum = part[0] + part[1];
          if (sum != 0.0f) atomicAdd(esum + blk * R + r, sum);
        }
      }
      __syncthreads();
      // acc = acc * r + e . (V * v_scale), one reference block at a time
      auto rescale = [&](int blk) {
#pragma unroll
        for (int i = 0; i < TR; ++i) {
          const float rs = rblk[blk * R + r0 + i];
#pragma unroll
          for (int d = 0; d < TD; ++d) acc[i][d] = __fmul_rn(acc[i][d], rs);
        }
      };
      auto pv = [&](int j0, int n) {
#pragma unroll 8
        for (int j = j0; j < j0 + n; ++j) {
          float e[TR], x[NG][TG];
          lds(e, e_s + j * R + r0);
#pragma unroll
          for (int h = 0; h < NG; ++h) lds(x[h], vv + j * DH + h * (DH / NG) + TG * td);
#pragma unroll
          for (int i = 0; i < TR; ++i)
#pragma unroll
            for (int h = 0; h < NG; ++h)
#pragma unroll
              for (int d = 0; d < TG; ++d)
                acc[i][h * TG + d] = __fmaf_rn(e[i], x[h][d], acc[i][h * TG + d]);
        }
      };
      if (bk >= kKvRows) {  // the stage is part of one block
        if (first) rescale(0);
        pv(0, kKvRows);
      } else {
        for (int blk = 0; blk < nbu; ++blk)
          if ((cc.mask >> blk) & 1u) {
            rescale(blk);
            pv(blk * bk, bk);
          }
      }
    }
    advance(cc, &n_iter);
  }
  pim::cp_async_wait<0>();
  __syncthreads();

  // ---- the last unit's sums, the output and the iteration counts -----------
  if (tid < R) {
    float den = den_s[tid];
    for (int i = 0; i < nbu; ++i)
      if ((pending >> i) & 1u) den = __fadd_rn(__fmul_rn(den, rblk[i * R + tid]), esum[i * R + tid]);
    den_s[tid] = den;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int r = r0 + i, hh = r / bq, row = qi * bq + r - hh * bq;
    if (hh >= a.hpc || row >= a.sq) continue;
    const float den = fmaxf(den_s[r], 1.0f);
    float* o = a.out + ((size_t)(bh0 + hh) * a.sq + row) * DH + TG * td;
#pragma unroll
    for (int h = 0; h < NG; ++h) {
      float y[TG];
#pragma unroll
      for (int d = 0; d < TG; ++d) y[d] = __fdiv_rn(acc[i][h * TG + d], den);
      stg(o + h * (DH / NG), y);
    }
  }
  if (tid == 0) {
    for (int hh = 0; hh < a.hpc; ++hh) a.iters[(size_t)(bh0 + hh) * a.n_qblk + qi] = n_iter;
  }
}

template <int DH, int R>
cudaError_t launch(const Args& a, dim3 grid, cudaStream_t stream) {
  static int granted = 0;
  auto kern = pim_attention_kernel<DH, R>;
  const int smem = layout(R, DH, a.bk).total;
  cudaError_t err = pim::allow_smem(kern, smem, &granted);
  if (err != cudaSuccess) return err;
  kern<<<grid, pim::kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// rows * DH <= 8192: 32 float32 accumulators a thread
template <int DH>
cudaError_t by_rows(int rows, const Args& a, dim3 grid, cudaStream_t s) {
  switch (rows) {
    case 16: return launch<DH, 16>(a, grid, s);
    case 32: return launch<DH, 32>(a, grid, s);
    case 64:
      if constexpr (DH <= 128) return launch<DH, 64>(a, grid, s);
      break;
    case 128:
      if constexpr (DH <= 64) return launch<DH, 128>(a, grid, s);
      break;
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// Dynamic shared memory of a launch with `rows` MMA rows.
extern "C" int pim_attention_smem_bytes(int rows, int dh, int block_k) {
  return layout(rows, dh, block_k).total;
}

// Launches on `stream`; returns cudaGetLastError() (0 on success).
// `page_table` is null for a dense cache; otherwise (nb, n_kblk) int32 and
// block_k is the page size.  A CTA serves `heads_per_cta` q heads of one KV
// group (q_per_kv / heads_per_cta CTAs a group) and one q block, as `rows`
// MMA rows; kernels/pim_attention.py::launch_plan chooses them.
extern "C" int pim_attention_launch(
    const void* q, const void* qs, const void* k, const void* ks,
    const void* v, const void* vs, const void* scalars, int nb,
    const void* page_table, const void* table, const void* levels, void* out,
    void* iters, int bh, int sq, int dh, int dhk, int sk, int block_q,
    int block_k, int n_qblk, int n_kblk, int q_per_kv, int h_per_b, int rows,
    int heads_per_cta, int causal, int window, int prune, float sm_scale,
    float score_scale, float qmax, float table_scale, void* stream) {
  const bool bk_ok = block_k % kKvRows == 0 ||
                     (block_k >= 8 && kKvRows % block_k == 0 && block_k % 8 == 0);
  if (!bk_ok || block_k <= 0 || dhk % 16 != 0 || (dhk != dh && 2 * dhk != dh) ||
      heads_per_cta < 1 || q_per_kv % heads_per_cta != 0 ||
      heads_per_cta * block_q > rows || rows * dh > 32 * pim::kThreads ||
      bh % q_per_kv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{static_cast<const int8_t*>(q), static_cast<const float*>(qs),
         static_cast<const int8_t*>(k), static_cast<const float*>(ks),
         static_cast<const int8_t*>(v), static_cast<const float*>(vs),
         static_cast<const int*>(scalars), static_cast<const int*>(page_table),
         static_cast<const int*>(table), static_cast<const int8_t*>(levels),
         static_cast<float*>(out), static_cast<int*>(iters),
         nb, sq, dhk, sk, block_q, block_k, n_qblk, n_kblk, q_per_kv, h_per_b,
         heads_per_cta, q_per_kv / heads_per_cta, causal, window, prune,
         sm_scale, score_scale, qmax, table_scale};
  const dim3 grid(n_qblk, bh / q_per_kv * a.splits);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  switch (dh) {
    case 32: err = by_rows<32>(rows, a, grid, s); break;
    case 64: err = by_rows<64>(rows, a, grid, s); break;
    case 96: err = by_rows<96>(rows, a, grid, s); break;
    case 128: err = by_rows<128>(rows, a, grid, s); break;
    case 256: err = by_rows<256>(rows, a, grid, s); break;
  }
  return static_cast<int>(err);
}
