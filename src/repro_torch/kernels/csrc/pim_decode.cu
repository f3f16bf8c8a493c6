// Split-K flash decode for PIM attention (Sq == 1, or k+1 verify rows) on
// Hopper (sm_90a), in one launch.
//
// Replaces the TPU kernel `repro/kernels/pim_decode.py::pim_decode_pallas`
// (body `_decode_kernel`, plus the stage-2 combine the JAX wrapper runs in
// jnp).  The q heads of one KV group and the verify positions are packed as
// rows r = l * G + g, each with its own causal bound q_pos + l.  Each KV
// partition (block_k rows of the dense cache, or one page of the pool) gives
// a partial (m, den, acc) per row from LUT exps; the combine rescales
// partition p by table[m_glob - m_p] / 2^15 (exactly 0 for a row with no
// score in p), adds the partials in partition order with separately rounded
// multiply and add, and divides by max(den, 1): no exp, the LUT domain only.
//
// What bounds it on the H100: a decode step reads each KV head's needed
// rows once (int8 or packed 4-bit, plus the f32 scale planes) and does a
// few operations per byte, so its bound is HBM bytes (3.35 TB/s).  At the
// served shapes (a few hundred rows a head) that bound is under a
// microsecond and the step is bound by latency instead: the launch, the
// dependent memory round trips (scalars and page table, the first K/V
// stage, the ticket, the combine's fetch of the partials), each some 1,500
// to 3,000 SM cycles on an NVIDIA H100 80GB HBM3 at 700 W, and a chain of
// barriers and short phases per stage (tools/ablate_decode.py marks and
// splits the time).  Measured there (chip_smoke.py): 0.0282 ms at kv_len
// 4096 against a 0.0103 ms bound, 10.85 / 13.82 us a served launch (the
// classic request / the paged trace) against 0.35 / 0.74 us.
//
// Design:
// * One launch per call.  Grid (chunks, B * Hkv * row tiles * dsplit).  A
//   row tile is up to 8 packed rows of one KV head (more rows take further
//   tiles, each an independent problem: rows never interact).  Where the
//   grid would stay small (the classic request: 32 heads of one partition)
//   an int8 tile is also cut into dsplit = Dh / 32 slices of the output's
//   head dims: each slice's CTAs score over the whole head dim and load and
//   sum V for their 32 dims only (the sum of each output element is the
//   same).  For each tile the
//   needed partitions form one range [lo, hi], from kv_len, q_pos, the last
//   valid row's q_pos + min(q_len, Sq) - 1, causal and window; in paged mode
//   unallocated entries inside it are skipped.  The range, in units (the
//   128 / block_k partitions of one 128-row stage where block_k is 16, 32
//   or 64; else one partition, of cdiv(block_k, 128) stages, its rows past
//   block_k zero-filled and masked), is cut into `chunks` contiguous runs
//   (the wrapper sizes chunks from the SM count, for two CTAs an SM); CTA c
//   takes run c, and a CTA whose run is empty exits after reading the
//   scalars.
// * Head dim 256: a CTA over the whole head dim takes 185,488 bytes of
//   shared memory at 8-row tiles (one CTA an SM, 255 registers allowed);
//   a small grid's 32-dim slices take 115-128 KB.
// * Head dim 96 (phi-3-vision-4.2b): three k32 MMA steps; over the whole
//   head dim a lane sums 3 dims (its V bytes are not 4-aligned: v_scaled's
//   scalar path), and a small int8 grid is cut into dsplit 3 slices of 32.
//   A record is RT * 98 floats, a multiple of 16 bytes, as the combine's
//   16-byte copies need.  4-bit rows (48 bytes) are unpacked into int8
//   levels in the ring (codes c and c + 48) before any lane reads them.
// * Staging: each unit's K stages, then its V stages, 128 rows each, by
//   16-byte `cp.async.cg` copies into a 3-slot ring, two stages ahead of the
//   one computed (4-bit KV is decoded to int8 levels by synchronous loads
//   into the same ring).  Rows past kv_len or block_k, of unallocated pages
//   and of partitions outside the range are zero-filled without a load; a
//   128-row stage of a dense partition that is masked for every row of the
//   tile is not staged at all (its keys would add exact zeros).  A dense tile's
//   first CTA, without a window, loads its first K stage before the scalars
//   arrive: its run starts at key 0 whatever the lengths.
// * Scores on s8 tensor cores: mma.sync m16n8k32 with the tile's q rows as
//   A (rows past the tile zero) and the warp's 16 keys as two n8 B tiles,
//   by ldmatrix.  Only the tile's rows of the fragments are real, so each
//   lane codes RT / 2 of the warp's RT x 16 scores, moved to it by shuffles.
//   Codes stay integers (`pim::score_code_int`); each partition's row
//   maxima are reduced over the row's lanes and across warps by shared
//   atomic max.
// * One LUT step per partition, never merged: every partition keeps its own
//   m, exps, den and acc, even where eight 16-token pages share a stage.
// * PV on the CUDA cores, split over warps by keys: warp w owns keys
//   16w .. 16w + 15 of every stage, and each lane Dh / 32 of the head dims
//   of every row, summing e * (V * v_scale) by fused multiply-add in key
//   order over the partition's stages.  A 16-token page is one warp's; a
//   longer partition's warp sums are added in warp order at its end.  That
//   order depends only on block_k, never on the rows packed, on paged or
//   dense storage, or on how partitions fall to CTAs.
// * The combine runs in the same launch.  Where the range is one partition
//   (the classic request's 160-row cache, a slot of one page) its CTA
//   writes the output at once, with the combine's own rescale of it.
//   Otherwise each CTA writes one partial record (m, den, acc of the tile's
//   rows) per partition it computed, to a scratch plane in device memory.
//   If the range fell to one CTA, it combines its own records; else every
//   CTA takes a ticket (an atomic counter per tile, after __threadfence) and
//   the last to arrive combines, then resets the counter to 0 for the next
//   launch.  An unallocated page inside the range has no record and adds
//   nothing.  The combiner takes the rows' global maxima over the range, then
//   walks the records in partition order, two `cp.async` chunks at a time,
//   each chunk's rescales computed at once, and writes the output in the
//   (B * H, Sq, Dh) layout of q and the (B * Hkv, n_k) iteration map.
//
// Exactness: score codes equal the reference bit for bit (same multiply
// order, IEEE division, round half to even); maxima and exps are the
// reference's per partition; den sums integers below 2^24, exact in any
// order.  Only acc is summed in another order than the plain version's
// einsum.  Every row's arithmetic depends only on its own q row, bound and
// the partition, so verify rows are bit-identical to the single-step
// decodes at their positions, and paged equals dense at block_k == page
// size.  Skipping a partition outside the range, an unallocated page or a
// fully masked stage adds exact zeros, as the reference's skipped
// partitions do.

#include "pim_common.cuh"

namespace {

constexpr int kKvRows = 128;                  // KV rows per cp.async stage
constexpr int kStages = 3;                    // ring slots
constexpr int kKeys = kKvRows / pim::kWarps;  // keys a warp owns in a stage (16)
constexpr short kMasked = -32768;             // the int16 code of a masked score
constexpr int kNegInt = -(1 << 24);           // pim::kNeg as an int

__host__ __device__ constexpr int slot_ld(int dh) { return dh + 16; }
__host__ __device__ constexpr int slot_bytes(int dh) {
  return kKvRows * slot_ld(dh) + kKvRows * 4;
}
__host__ __device__ constexpr int align16(int x) { return (x + 15) & ~15; }
// Blocks of 16, 32 or 64 rows are packed, 128 / bk to a unit of one stage
// (a warp's 16 keys lie in one block); any other block_k is a unit of its
// own, of cdiv(bk, 128) stages, its rows past bk zero-filled and masked.
__host__ __device__ constexpr bool packed(int bk) { return bk == 16 || bk == 32 || bk == 64; }
__host__ __device__ constexpr int blocks_a_unit(int bk) { return packed(bk) ? kKvRows / bk : 1; }
__host__ __device__ constexpr int stages_a_unit(int bk) {
  return packed(bk) ? 1 : (bk + kKvRows - 1) / kKvRows;
}
// One partition's partial record: m[rt] (int), den[rt], acc[rt][dh].
__host__ __device__ constexpr int rec_bytes(int rt, int dh) { return rt * (dh + 2) * 4; }

// Byte offsets of the dynamic shared memory, for `rt` rows a tile, head dim
// `dh` (`dv` of it in PV), block_k `bk` and `n_pt` page-table entries (0 for
// a dense cache); kernels/pim_decode.py::smem_bytes repeats the total.
struct Layout {
  int tab, qs, q, lev, mg, pt, bmax, codes, ew, red, ring, total;
};

__host__ __device__ inline Layout layout(int rt, int dh, int dv, int bk, int n_pt) {
  const int unit = stages_a_unit(bk) * kKvRows;
  const int nbu = blocks_a_unit(bk);
  Layout L;
  int o = 0;
  L.tab = o;   o += 256 * 4;                        // exp table (int)
  L.qs = o;    o += align16(rt * 4);                // q scales
  L.q = o;     o += 16 * slot_ld(dh);               // q rows, the MMA's A
  L.lev = o;   o += 16;                             // 4-bit levels
  L.mg = o;    o += align16(rt * 4);                // combine: row maxima
  L.pt = o;    o += align16(n_pt * 4);              // the slot's page-table row
  L.bmax = o;  o += align16(2 * nbu * rt * 4);      // two banks of block maxima
  L.codes = o; o += align16(unit * rt * 2);         // int16 codes [j][row]
  L.ew = o;    o += pim::kWarps * kKeys * rt * 4;   // each warp's exps [j][row]
  L.red = o;   o += pim::kWarps * rt * (dv + 1) * 4;  // warp sums: acc, then den
  L.ring = o;  o += kStages * slot_bytes(dh);
  L.total = o;
  return L;
}

struct Args {
  const int8_t* q;      // (B * H, Sq, Dh)
  const float* qs;      // (B * H, Sq)
  const int8_t* k;
  const float* ks;
  const int8_t* v;
  const float* vs;
  const int* scalars;   // (3, nb): q_offset, kv_len, q_len
  const int* pt;        // (nb, n_k) page table, or null (dense)
  const int* table;
  const int8_t* levels;
  unsigned char* part;  // (tiles, n_k) partial records
  int* counters;        // (tiles,) zeros, left zero
  float* out;           // (B * H, Sq, Dh)
  int* iters;           // (B * Hkv, n_k)
  int nb, n_rt, dsplit, chunks, g, sq, rows, dhk, sk, bk, n_k, h_per_b, causal, window;
  float sm_scale, score_scale, qmax, table_scale;
};

// The next stage to load or compute: stage c of unit u, its K (kind 0) or
// V (kind 1) rows.  Stages c_lo..c_hi of the unit are computed; `mask` has
// bit i set for each needed partition i of the unit.
struct Cursor {
  int u, c, kind, c_lo, c_hi;
  unsigned mask;
  bool ok;
};

template <int N>
__device__ __forceinline__ void lds(float (&d)[N], const float* p) {
  static_assert(N == 2 || N == 4 || N == 8, "vector loads");
#pragma unroll
  for (int i = 0; i < N; i += 4) {
    if constexpr (N == 2) {
      const float2 x = *reinterpret_cast<const float2*>(p);
      d[0] = x.x; d[1] = x.y;
    } else {
      const float4 x = *reinterpret_cast<const float4*>(p + i);
      d[i] = x.x; d[i + 1] = x.y; d[i + 2] = x.z; d[i + 3] = x.w;
    }
  }
}

// The int8 V values of one key at this lane's DPL head dims, times the
// key's scale: (float)v * v_scale, one rounding, as the plain version.
template <int DPL>
__device__ __forceinline__ void v_scaled(float (&x)[DPL], const int8_t* p, float sc) {
  if constexpr (DPL == 4) {
    // int8 v -> float: the bits 0x4B0000 | (v + 128) are 2^23 + v + 128
    const uint32_t w = *reinterpret_cast<const uint32_t*>(p) ^ 0x80808080u;
    auto val = [&](unsigned sel) {
      return __fadd_rn(__uint_as_float(__byte_perm(w, 0x4B000000u, sel)), -8388736.0f);
    };
    x[0] = __fmul_rn(val(0x7440), sc);
    x[1] = __fmul_rn(val(0x7441), sc);
    x[2] = __fmul_rn(val(0x7442), sc);
    x[3] = __fmul_rn(val(0x7443), sc);
  } else {
#pragma unroll
    for (int d = 0; d < DPL; ++d) x[d] = __fmul_rn(static_cast<float>(p[d]), sc);
  }
}

// Two CTAs an SM where two fit; at head_dim 256 and the whole head dim a
// CTA (dsplit 1) its shared memory leaves room for one.
template <int DH, int RT, int DV>
__global__ void __launch_bounds__(pim::kThreads, DH > 128 && DV == DH ? 1 : 2)
pim_decode_kernel(const Args a) {
  constexpr int KS = DH / 32;                // k32 steps of the scores
  constexpr int LD = slot_ld(DH);
  constexpr int DPL = DV / 32;               // head dims a lane accumulates
  constexpr int REC = rec_bytes(RT, DV);
  constexpr int T = pim::kThreads;
  constexpr int ITEMS = (RT * DV + T - 1) / T;  // combine outputs a thread
  static_assert(RT == 2 || RT == 4 || RT == 8, "2, 4 or 8 rows a tile");

  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_last;
  const int bk = a.bk;
  const bool paged = a.pt != nullptr;
  const Layout L = layout(RT, DH, DV, bk, paged ? a.n_k : 0);
  int* tab = reinterpret_cast<int*>(smem + L.tab);
  float* qs_s = reinterpret_cast<float*>(smem + L.qs);
  int8_t* q_s = reinterpret_cast<int8_t*>(smem + L.q);
  int8_t* lev_s = reinterpret_cast<int8_t*>(smem + L.lev);
  int* mg = reinterpret_cast<int*>(smem + L.mg);
  int* pt_s = reinterpret_cast<int*>(smem + L.pt);
  int* bmax = reinterpret_cast<int*>(smem + L.bmax);
  short* codes = reinterpret_cast<short*>(smem + L.codes);
  float* ew = reinterpret_cast<float*>(smem + L.ew);
  float* red = reinterpret_cast<float*>(smem + L.red);
  float* dred = red + pim::kWarps * RT * DV;
  unsigned char* ring = smem + L.ring;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // (bhkv * n_rt + row tile) * dsplit + head-dim slice: the records and
  // the counter of this CTA's tile
  const int tile = blockIdx.y;
  const int rtile = tile / a.dsplit;
  const int d0 = (tile - rtile * a.dsplit) * DV;  // the slice's first head dim
  const int bhkv = rtile / a.n_rt;
  const int r0 = (rtile - bhkv * a.n_rt) * RT;    // the tile's first packed row
  const int chunk = blockIdx.x;
  const int b = bhkv / a.h_per_b;
  // dense: the flat b * Hkv + h KV row; paged: h, inside each page row
  const int kvh = paged ? bhkv % a.h_per_b : bhkv;
  const int n_pt = paged ? a.n_k : 0;
  // packed row r of the tile: q row (bhkv * G + g) * Sq + l, or -1
  auto q_row = [&](int r) -> long {
    const int rg = r0 + r;
    if (r >= RT || rg >= a.rows) return -1L;
    const int l = rg / a.g;
    return (long)(bhkv * a.g + rg - l * a.g) * a.sq + l;
  };

  // ---- set-up copies that need no scalar ----------------------------------
  for (int i = tid; i < 16 * (DH / 16); i += T) {
    const int r = i / (DH / 16), c = i - r * (DH / 16);
    const long row = q_row(r);
    pim::cp_async16(q_s + r * LD + 16 * c, row < 0 ? a.q : a.q + row * DH + 16 * c,
                    row < 0 ? 0 : 16);
  }
  if (tid < RT) {
    const long row = q_row(tid);
    pim::cp_async4(qs_s + tid, row < 0 ? a.qs : a.qs + row, row < 0 ? 0 : 4);
  }
  if (tid < 64) pim::cp_async16(tab + 4 * tid, a.table + 4 * tid, 16);
  for (int i = tid; i < n_pt; i += T)
    pim::cp_async4(pt_s + i, a.pt + (size_t)b * a.n_k + i, 4);
  pim::cp_async_commit();
  const int8_t lev_v = tid < 16 ? a.levels[tid] : 0;
  const int q_pos = a.scalars[b];
  const int kv_len = a.scalars[a.nb + b];
  const int q_len = a.scalars[2 * a.nb + b];
  // The run of a dense tile's chunk 0 without a window starts at key 0
  // whatever the lengths, so its first K stage (rows past Sk zero) is loaded
  // into slot 0 before the scalars arrive.  Rows past kv_len or of partitions
  // past the range are masked like zero-filled ones.
  const bool spec = !paged && chunk == 0 && !a.window && a.dhk == DH;
  if (spec) {
    int8_t* dst = reinterpret_cast<int8_t*>(ring);
    for (int i = tid; i < kKvRows * (DH / 16); i += T) {
      const int j = i / (DH / 16), c = i - j * (DH / 16);
      const bool in = j < a.sk;
      pim::cp_async16(dst + j * LD + 16 * c, in ? a.k + ((long)kvh * a.sk + j) * DH + 16 * c : a.k,
                      in ? 16 : 0);
    }
    if (tid < kKvRows) {
      const bool in = tid < a.sk;
      pim::cp_async4(reinterpret_cast<float*>(dst + kKvRows * LD) + tid,
                     in ? a.ks + (long)kvh * a.sk + tid : a.ks, in ? 4 : 0);
    }
  }
  pim::cp_async_commit();

  // ---- the needed partitions [lo, hi] and this CTA's run of units --------
  const int n_valid = min(q_len, a.sq);
  const int q_hi = q_pos + n_valid - 1;   // the last valid row's position
  int lo = 0;
  int hi = kv_len > 0 ? min(a.n_k - 1, (kv_len - 1) / bk) : -1;
  if (a.causal) hi = q_hi >= 0 ? min(hi, q_hi / bk) : -1;
  if (a.window) {
    const int t = q_pos - a.window + 1;   // block ki is needed iff (ki + 1) * bk > t
    lo = t > 0 ? t / bk : 0;
  }
  if (q_len <= 0) hi = -1;
  const bool pk = packed(bk);
  const int nbu = blocks_a_unit(bk);   // partitions a unit
  const int n_st = stages_a_unit(bk);  // stages a unit
  const int n_units = hi >= lo ? hi / nbu - lo / nbu + 1 : 0;
  const int per = n_units > 0 ? (n_units + a.chunks - 1) / a.chunks : 1;
  const int n_active = (n_units + per - 1) / per;
  if (chunk >= max(n_active, 1)) {
    pim::cp_async_wait<0>();
    return;
  }
  auto alloc = [&](int ki) { return !paged || pt_s[ki] >= 0; };
  // the combine's rescale of a range of one partition: m_glob == m_p
  auto one_step = [&](int m_p) {
    return m_p <= kNegInt / 2 ? 0.0f : __fmul_rn(static_cast<float>(tab[0]), a.table_scale);
  };

  if (n_units == 0) {  // nothing to attend: zeros, no partition ran
    pim::cp_async_wait<0>();
    for (int i = tid; i < RT * DV; i += T) {
      const long row = q_row(i / DV);
      if (row >= 0) a.out[row * DH + d0 + i % DV] = 0.0f;
    }
    if (r0 == 0 && d0 == 0)
      for (int p = tid; p < a.n_k; p += T) a.iters[(size_t)bhkv * a.n_k + p] = 0;
    return;
  }
  const int u_begin = lo / nbu + chunk * per;
  const int u_end = min(u_begin + per, hi / nbu + 1);

  if (tid < 16) lev_s[tid] = lev_v;
  for (int i = tid; i < 2 * nbu * RT; i += T) bmax[i] = kNegInt;
  pim::cp_async_wait<1>();  // the set-up copies; the first K stage may still fly
  __syncthreads();
  uint32_t qa[KS][4];
  {
    const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8;
    const int a_k = (lane >> 4) * 16;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) pim::ldsm_x4(qa[kk], q_s + a_row * LD + kk * 32 + a_k);
  }

  // ---- the walk over units and stages -------------------------------------
  auto unit_mask = [&](int u) {
    unsigned mask = 0;
    for (int i = 0; i < nbu; ++i) {
      const int ki = u * nbu + i;
      if (ki >= lo && ki <= hi && alloc(ki)) mask |= 1u << i;
    }
    return mask;
  };
  // can any score of the stage's rows from k0 be unmasked for a row of the tile?
  auto stage_live = [&](int k0) {
    bool ok = k0 < kv_len;
    if (a.causal) ok = ok && k0 <= q_hi;
    if (a.window) ok = ok && k0 + kKvRows - 1 > q_pos - a.window;
    return ok;
  };
  auto seek = [&](Cursor& cu, int u) {
    for (; u < u_end; ++u) {
      const unsigned mask = unit_mask(u);
      if (!mask) continue;
      int lo_c = 0, hi_c = 0;
      if (!pk) {  // one partition: skip its stages masked everywhere
        lo_c = n_st;
        hi_c = -1;
        for (int c = 0; c < n_st; ++c)
          if (stage_live(u * bk + c * kKvRows)) {
            lo_c = min(lo_c, c);
            hi_c = c;
          }
        if (hi_c < lo_c) lo_c = hi_c = 0;  // all masked: one stage gives (kNeg, 0, 0)
      }
      cu = Cursor{u, lo_c, 0, lo_c, hi_c, mask, true};
      return;
    }
    cu.ok = false;
  };
  auto advance = [&](Cursor& cu) {
    if (cu.c < cu.c_hi) {
      ++cu.c;
    } else if (cu.kind == 0) {
      cu.kind = 1;
      cu.c = cu.c_lo;
    } else {
      seek(cu, cu.u + 1);
    }
  };
  const int sh = pk ? __ffs(bk) - 1 : 0;   // log2 of a packed block
  // (token, head) index of row j of the stage at `cu`, or -1 (zeros)
  auto row_of = [&](const Cursor& cu, int j) -> long {
    const int blk = pk ? j >> sh : 0;
    if (!((cu.mask >> blk) & 1u)) return -1L;
    const int ki = cu.u * nbu + blk;
    const int jb = pk ? j & (bk - 1) : cu.c * kKvRows + j;
    const int pos = ki * bk + jb;
    if ((!pk && jb >= bk) || pos >= kv_len) return -1L;  // masked for every row
    if (!paged) return pos < a.sk ? (long)kvh * a.sk + pos : -1L;
    return ((long)pt_s[ki] * bk + jb) * a.h_per_b + kvh;
  };
  auto issue = [&](const Cursor& cu, int slot) {
    int8_t* dst = reinterpret_cast<int8_t*>(ring + slot * slot_bytes(DH));
    float* dsc = reinterpret_cast<float*>(dst + kKvRows * LD);
    const int8_t* src = cu.kind ? a.v : a.k;
    const float* ssrc = cu.kind ? a.vs : a.ks;
    if (a.dhk == DH && (cu.kind == 0 || DV == DH)) {
      constexpr int V = DH / 16;
      for (int i = tid; i < kKvRows * V; i += T) {
        const int j = i / V, c = i - j * V;
        const long row = row_of(cu, j);
        pim::cp_async16(dst + j * LD + 16 * c, row < 0 ? src : src + row * DH + 16 * c,
                        row < 0 ? 0 : 16);
      }
    } else if (a.dhk == DH) {  // V of the slice's head dims, at column 0
      constexpr int V = DV / 16;
      for (int i = tid; i < kKvRows * V; i += T) {
        const int j = i / V, c = i - j * V;
        const long row = row_of(cu, j);
        pim::cp_async16(dst + j * LD + 16 * c, row < 0 ? src : src + row * DH + d0 + 16 * c,
                        row < 0 ? 0 : 16);
      }
    } else {  // 4 bits: byte c holds code c (low nibble) and c + DH / 2
      const int words = a.dhk / 4;
      for (int i = tid; i < kKvRows * words; i += T) {
        const int j = i / words, w = i - j * words;
        const long row = row_of(cu, j);
        uint32_t lo4 = 0, hi4 = 0;
        if (row >= 0) {
          const uint32_t val = reinterpret_cast<const uint32_t*>(src + row * a.dhk)[w];
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            const uint32_t byte = (val >> (8 * x)) & 0xFFu;
            lo4 |= static_cast<uint32_t>(static_cast<uint8_t>(lev_s[byte & 0xFu])) << (8 * x);
            hi4 |= static_cast<uint32_t>(static_cast<uint8_t>(lev_s[byte >> 4])) << (8 * x);
          }
        }
        *reinterpret_cast<uint32_t*>(dst + j * LD + 4 * w) = lo4;
        *reinterpret_cast<uint32_t*>(dst + j * LD + DH / 2 + 4 * w) = hi4;
      }
    }
    if (tid < kKvRows) {
      const long row = row_of(cu, tid);
      pim::cp_async4(dsc + tid, row < 0 ? ssrc : ssrc + row, row < 0 ? 0 : 4);
    }
  };

  // scores: a lane codes VPL of the warp's RT x 16 scores, all of row r_l
  // (32 / RT lanes a row); its query position; B fragments of the warp's
  // 16 keys
  constexpr int VPL = RT / 2;
  const int qd = lane & 3;
  const int r_l = (lane * VPL) >> 4;
  const long my_q = q_row(r_l);
  const int l_row = my_q < 0 ? 0 : (r0 + r_l) / a.g;
  const bool row_ok = my_q >= 0 && l_row < n_valid;
  const int qp = q_pos + l_row;
  const float my_qs = qs_s[r_l];
  const int b_row = (lane & 7) + (lane >> 4) * 8, b_k = ((lane >> 3) & 1) * 16;
  const int wkey = warp * kKeys;                        // the warp's first key
  const int wblk = pk ? wkey >> sh : 0;                 // its partition in a unit
  const int wpb = pk ? bk / kKeys : pim::kWarps;        // warps a partition
  // the range is one allocated partition: no records, no combine
  const bool single = hi == lo && alloc(lo);
  const int qmax = static_cast<int>(a.qmax);
  float acc[RT][DPL], dsum[RT];

  Cursor pc, cc;
  seek(pc, u_begin);
  cc = pc;
  int s0 = 0;  // the first slot the prologue fills
  if (spec && pc.ok && pc.u == 0 && pc.c == 0) {
    advance(pc);  // slot 0 holds the run's first stage already
    s0 = 1;
  } else if (spec) {
    pim::cp_async_wait<0>();  // slot 0 is refilled: its copies land first
  }
#pragma unroll 1
  for (int s = s0; s < kStages - 1; ++s) {
    if (pc.ok) {
      issue(pc, s);
      advance(pc);
    }
    pim::cp_async_commit();
  }
  int n_unit = -1;  // units computed so far, less one: the block-maxima bank
  for (int n = 0; cc.ok; ++n) {
    pim::cp_async_wait<kStages - 2>();
    __syncthreads();  // stage n landed; stage n - 1 is no longer read
    if (pc.ok) {
      issue(pc, (n + kStages - 1) % kStages);
      advance(pc);
    }
    pim::cp_async_commit();
    const int8_t* st = reinterpret_cast<const int8_t*>(ring + (n % kStages) * slot_bytes(DH));
    const float* tsc = reinterpret_cast<const float*>(st + kKvRows * LD);
    const int jj0 = pk ? 0 : cc.c * kKvRows;              // the stage's first unit row
    const int k0 = cc.u * nbu * bk + jj0;                  // its first key position

    if (cc.kind == 0) {
      // ---- scores -> masked codes and partition row maxima ----------------
      if (cc.c == cc.c_lo) {  // a new unit: clear the other bank for the next
        ++n_unit;
        for (int i = tid; i < nbu * RT; i += T) bmax[((n_unit + 1) & 1) * nbu * RT + i] = kNegInt;
      }
      int* bm = bmax + (n_unit & 1) * nbu * RT;
      // C = the bits of 1.5 * 2^23: the int32 sums land in the bits of the
      // float 1.5 * 2^23 + s_int (|s_int| <= 2^21), read with one add
      int s[2][4];
#pragma unroll
      for (int t = 0; t < 2; ++t) s[t][0] = s[t][1] = s[t][2] = s[t][3] = 0x4B400000;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t x4[4];
        pim::ldsm_x4(x4, st + (wkey + b_row) * LD + kk * 32 + b_k);
        const uint32_t b0[2] = {x4[0], x4[1]}, b1[2] = {x4[2], x4[3]};
        pim::mma_k32(s[0], qa[kk], b0);
        pim::mma_k32(s[1], qa[kk], b1);
      }
      const bool blk_ok = (cc.mask >> wblk) & 1u;
      int mx = kNegInt;
#pragma unroll
      for (int i = 0; i < VPL; ++i) {
        int k, sv;
        if constexpr (RT == 8) {  // the fragment's own: row g, tile i / 2, column i % 2
          k = (i >> 1) * 8 + 2 * qd + (i & 1);
          sv = s[i >> 1][i & 1];
        } else {  // only rows g < RT are real: fetch the lane's value from its holder
          k = (lane * VPL + i) & 15;
          const int src = r_l * 4 + ((k & 7) >> 1);
          const int v00 = __shfl_sync(0xffffffffu, s[0][0], src);
          const int v01 = __shfl_sync(0xffffffffu, s[0][1], src);
          const int v10 = __shfl_sync(0xffffffffu, s[1][0], src);
          const int v11 = __shfl_sync(0xffffffffu, s[1][1], src);
          sv = k & 8 ? (k & 1 ? v11 : v10) : (k & 1 ? v01 : v00);
        }
        const int col = wkey + k;
        const int pos = k0 + col;
        bool ok = row_ok && blk_ok && pos < kv_len && jj0 + col < nbu * bk;
        if (a.causal) ok = ok && pos <= qp;
        if (a.window) ok = ok && pos > qp - a.window;
        const int c = pim::score_code_int(__fadd_rn(__int_as_float(sv), -12582912.0f), my_qs,
                                          tsc[col], a.sm_scale, a.score_scale, qmax);
        codes[(jj0 + col) * RT + r_l] = ok ? static_cast<short>(c) : kMasked;
        if (ok) mx = max(mx, c);
      }
#pragma unroll
      for (int o = 1; o < 32 / RT; o <<= 1) mx = max(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      if ((lane & (32 / RT - 1)) == 0 && mx > kNegInt) atomicMax(bm + wblk * RT + r_l, mx);
    } else {
      // ---- exps and PV of the warp's 8 keys --------------------------------
      const int* bm = bmax + (n_unit & 1) * nbu * RT;
      float* my_e = ew + warp * kKeys * RT;
      for (int i = lane; i < kKeys * RT; i += 32) {
        const int j = i / RT, r = i - j * RT;
        const short c = codes[(jj0 + wkey + j) * RT + r];
        my_e[i] = c == kMasked ? 0.0f
                               : static_cast<float>(tab[min(max(bm[wblk * RT + r] - c, 0), 255)]);
      }
      __syncwarp();
      if (cc.c == cc.c_lo) {
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          dsum[r] = 0.0f;
#pragma unroll
          for (int d = 0; d < DPL; ++d) acc[r][d] = 0.0f;
        }
      }
#pragma unroll 4
      for (int j = 0; j < kKeys; ++j) {
        float vd[DPL], e[RT];
        v_scaled<DPL>(vd, st + (wkey + j) * LD + lane * DPL, tsc[wkey + j]);
        lds(e, my_e + j * RT);
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          dsum[r] = __fadd_rn(dsum[r], e[r]);
#pragma unroll
          for (int d = 0; d < DPL; ++d) acc[r][d] = __fmaf_rn(e[r], vd[d], acc[r][d]);
        }
      }
      if (cc.c == cc.c_hi && wpb == 1) {
        // ---- a warp's own partition ends: its record, or the output ------
        if ((cc.mask >> wblk) & 1u) {
          unsigned char* rec = a.part + ((size_t)tile * a.n_k + cc.u * nbu + wblk) * REC;
#pragma unroll
          for (int r = 0; r < RT; ++r) {
            const int m_p = bm[wblk * RT + r];
            if (single) {
              const long row = q_row(r);
              const float rs = one_step(m_p);
#pragma unroll
              for (int d = 0; d < DPL; ++d)
                if (row >= 0)
                  a.out[row * DH + d0 + lane * DPL + d] = __fdiv_rn(
                      __fmul_rn(acc[r][d], rs), fmaxf(__fmul_rn(dsum[r], rs), 1.0f));
            } else {
#pragma unroll
              for (int d = 0; d < DPL; ++d)
                reinterpret_cast<float*>(rec + 2 * RT * 4)[r * DV + lane * DPL + d] = acc[r][d];
              if (lane == 0) {
                reinterpret_cast<int*>(rec)[r] = m_p;
                reinterpret_cast<float*>(rec)[RT + r] = dsum[r];
              }
            }
          }
        }
      } else if (cc.c == cc.c_hi) {
        // ---- the unit's partitions end: warp sums in warp order -> records
#pragma unroll
        for (int r = 0; r < RT; ++r)
#pragma unroll
          for (int d = 0; d < DPL; ++d) red[(warp * RT + r) * DV + lane * DPL + d] = acc[r][d];
        if (lane == 0)
#pragma unroll
          for (int r = 0; r < RT; ++r) dred[warp * RT + r] = dsum[r];
        __syncthreads();
        for (int i = tid; i < nbu * RT * DV; i += T) {
          const int bi = i / (RT * DV), rem = i - bi * (RT * DV);
          if (!((cc.mask >> bi) & 1u)) continue;
          const int w0 = bi * wpb, r = rem / DV;
          float sum = red[w0 * RT * DV + rem];
          for (int w = 1; w < wpb; ++w) sum = __fadd_rn(sum, red[(w0 + w) * RT * DV + rem]);
          float den = dred[w0 * RT + r];
          for (int w = 1; w < wpb; ++w) den = __fadd_rn(den, dred[(w0 + w) * RT + r]);
          const int m_p = bm[bi * RT + r];
          if (single) {
            const long row = q_row(r);
            const float rs = one_step(m_p);
            if (row >= 0)
              a.out[row * DH + d0 + rem % DV] =
                  __fdiv_rn(__fmul_rn(sum, rs), fmaxf(__fmul_rn(den, rs), 1.0f));
            continue;
          }
          unsigned char* rec = a.part + ((size_t)tile * a.n_k + cc.u * nbu + bi) * REC;
          reinterpret_cast<float*>(rec + 2 * RT * 4)[rem] = sum;
          if (rem % DV == 0) {
            reinterpret_cast<int*>(rec)[r] = m_p;
            reinterpret_cast<float*>(rec)[RT + r] = den;
          }
        }
      }
    }
    advance(cc);
  }
  pim::cp_async_wait<0>();
  if (single) {
    if (r0 == 0 && d0 == 0)
      for (int p = tid; p < a.n_k; p += T) a.iters[(size_t)bhkv * a.n_k + p] = p == lo;
    return;
  }
  __threadfence();
  __syncthreads();

  // ---- the combine, by the last CTA of the tile to finish ------------------
  if (n_active > 1) {
    if (tid == 0) s_last = atomicAdd(a.counters + tile, 1) == n_active - 1;
    __syncthreads();
    if (!s_last) return;
    __threadfence();
  }
  const unsigned char* recs = a.part + (size_t)tile * a.n_k * REC;
  float* rs_s = red;  // a chunk's rescales [record][row] (C * RT floats)
  // records lo + k * C .. in ring half k & 1 (C >= 1 at every head dim / row count)
  constexpr int C = (kStages * slot_bytes(DH) / 2) / REC;
  auto fetch = [&](int k) {
    const int p0 = lo + k * C, n = min(C, hi + 1 - p0);
    unsigned char* dst = ring + (k & 1) * C * REC;
    const unsigned char* src = recs + (size_t)p0 * REC;
    for (int i = tid; i < n * (REC / 16); i += T) pim::cp_async16(dst + 16 * i, src + 16 * i, 16);
  };
  fetch(0);
  pim::cp_async_commit();
  if (tid < RT) mg[tid] = kNegInt;
  __syncthreads();
  const int n_p = hi - lo + 1;
  const int n_chunks = (n_p + C - 1) / C;
  // the rows' maxima: from the records in device memory, or from the one
  // chunk once it has landed
  auto row_maxima = [&](bool landed) {
    for (int i = tid; i < n_p * RT; i += T) {
      const int q = i / RT, r = i - q * RT;
      if (!alloc(lo + q)) continue;
      const int* m = reinterpret_cast<const int*>((landed ? ring : recs + (size_t)lo * REC) + q * REC);
      atomicMax(mg + r, landed ? m[r] : __ldcg(m + r));
    }
    __syncthreads();
  };
  if (n_chunks > 1) row_maxima(false);
  float den[ITEMS], out[ITEMS];
#pragma unroll
  for (int it = 0; it < ITEMS; ++it) den[it] = out[it] = 0.0f;
  for (int k = 0; k < n_chunks; ++k) {
    if (k + 1 < n_chunks) fetch(k + 1);
    pim::cp_async_commit();
    pim::cp_async_wait<1>();
    __syncthreads();
    if (n_chunks == 1) row_maxima(true);
    const unsigned char* chunk_recs = ring + (k & 1) * C * REC;
    const int p0 = lo + k * C, n = min(C, hi + 1 - p0);
    for (int i = tid; i < n * RT; i += T) {   // the chunk's rescales, all at once
      const int q = i / RT, r = i - q * RT;
      // an unallocated page of the range has no record: its bytes are
      // whatever the plane held, never read as a maximum
      const int m_p =
          alloc(p0 + q) ? reinterpret_cast<const int*>(chunk_recs + q * REC)[r] : kNegInt;
      rs_s[i] = m_p <= kNegInt / 2
                    ? 0.0f
                    : __fmul_rn(static_cast<float>(tab[min(max(mg[r] - m_p, 0), 255)]),
                                a.table_scale);
    }
    __syncthreads();
#pragma unroll 4
    for (int q = 0; q < n; ++q) {
      if (!alloc(p0 + q)) continue;
      const float* rec = reinterpret_cast<const float*>(chunk_recs + q * REC);
#pragma unroll
      for (int it = 0; it < ITEMS; ++it) {
        const int i = tid + it * T;
        if (i >= RT * DV) break;
        const float rs = rs_s[q * RT + i / DV];
        den[it] = __fadd_rn(den[it], __fmul_rn(rec[RT + i / DV], rs));
        out[it] = __fadd_rn(out[it], __fmul_rn(rec[2 * RT + i], rs));
      }
    }
    __syncthreads();  // the half is refilled two chunks on
  }
#pragma unroll
  for (int it = 0; it < ITEMS; ++it) {
    const int i = tid + it * T;
    if (i >= RT * DV) break;
    const long row = q_row(i / DV);
    if (row >= 0) a.out[row * DH + d0 + i % DV] = __fdiv_rn(out[it], fmaxf(den[it], 1.0f));
  }
  if (r0 == 0 && d0 == 0)
    for (int p = tid; p < a.n_k; p += T)
      a.iters[(size_t)bhkv * a.n_k + p] = p >= lo && p <= hi && alloc(p);
  if (n_active > 1 && tid == 0) a.counters[tile] = 0;
}

template <int DH, int RT, int DV>
cudaError_t launch(const Args& a, dim3 grid, cudaStream_t stream) {
  static int granted = 0;
  auto kern = pim_decode_kernel<DH, RT, DV>;
  const int smem = layout(RT, DH, DV, a.bk, a.pt ? a.n_k : 0).total;
  cudaError_t err = pim::allow_smem(kern, smem, &granted);
  if (err != cudaSuccess) return err;
  kern<<<grid, pim::kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int DH, int DV>
cudaError_t by_rows(int rt, const Args& a, dim3 grid, cudaStream_t s) {
  switch (rt) {
    case 2: return launch<DH, 2, DV>(a, grid, s);
    case 4: return launch<DH, 4, DV>(a, grid, s);
    case 8: return launch<DH, 8, DV>(a, grid, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// Dynamic shared memory of a launch with `rt` rows a tile, `dh / dsplit`
// head dims a CTA and `n_pt` page-table entries a slot (0 for a dense cache).
extern "C" int pim_decode_smem_bytes(int rt, int dh, int dsplit, int block_k, int n_pt) {
  return layout(rt, dh, dh / dsplit, block_k, n_pt).total;
}

// Launches on `stream`; returns cudaGetLastError() (0 on success).
// `page_table` is null for a dense cache; otherwise (nb, n_k) int32 and
// block_k is the page size.  `part` holds bhkv * n_rt * n_k records of
// rec_bytes(rt, dh / dsplit) bytes, times dsplit; `counters` bhkv * n_rt *
// dsplit zeroed int32, which the kernel leaves zeroed.  dsplit is 1, or
// dh / 32 for int8 KV: each CTA then takes 32 head dims of the output (its
// scores over the whole head dim).  kernels/pim_decode.py::launch_plan
// chooses rt, n_rt, dsplit and chunks.
extern "C" int pim_decode_launch(
    const void* q, const void* qs, const void* k, const void* ks, const void* v,
    const void* vs, const void* scalars, int nb, const void* page_table,
    const void* table, const void* levels, void* part, void* counters, void* out,
    void* iters, int bhkv, int n_rt, int rt, int dsplit, int chunks, int g, int sq, int dh,
    int dhk, int sk, int block_k, int n_k, int h_per_b, int causal, int window,
    float sm_scale, float score_scale, float qmax, float table_scale, void* stream) {
  if (block_k <= 0 || dhk % 16 != 0 || (dhk != dh && 2 * dhk != dh) ||
      chunks < 1 || n_rt < 1 || n_k < 1 || bhkv % nb != 0 || g < 1 ||
      (dsplit != 1 && (dsplit != dh / 32 || dh == 32 || dhk != dh)) ||
      (long)bhkv * n_rt * dsplit > 65535 || (long)(n_rt - 1) * rt >= (long)g * sq)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{static_cast<const int8_t*>(q), static_cast<const float*>(qs),
         static_cast<const int8_t*>(k), static_cast<const float*>(ks),
         static_cast<const int8_t*>(v), static_cast<const float*>(vs),
         static_cast<const int*>(scalars), static_cast<const int*>(page_table),
         static_cast<const int*>(table), static_cast<const int8_t*>(levels),
         static_cast<unsigned char*>(part), static_cast<int*>(counters),
         static_cast<float*>(out), static_cast<int*>(iters),
         nb, n_rt, dsplit, chunks, g, sq, g * sq, dhk, sk, block_k, n_k, h_per_b,
         causal, window, sm_scale, score_scale, qmax, table_scale};
  const dim3 grid(chunks, bhkv * n_rt * dsplit);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  switch (dh) {
    case 32: err = by_rows<32, 32>(rt, a, grid, s); break;
    case 64:
      err = dsplit == 1 ? by_rows<64, 64>(rt, a, grid, s) : by_rows<64, 32>(rt, a, grid, s);
      break;
    case 96:
      err = dsplit == 1 ? by_rows<96, 96>(rt, a, grid, s) : by_rows<96, 32>(rt, a, grid, s);
      break;
    case 128:
      err = dsplit == 1 ? by_rows<128, 128>(rt, a, grid, s) : by_rows<128, 32>(rt, a, grid, s);
      break;
    case 256:
      err = dsplit == 1 ? by_rows<256, 256>(rt, a, grid, s) : by_rows<256, 32>(rt, a, grid, s);
      break;
  }
  return static_cast<int>(err);
}
