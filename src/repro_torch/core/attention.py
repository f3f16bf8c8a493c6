"""AttentionLego attention numerics: the int8 KV cache, quantize-on-write,
the behavioral (paper-faithful) PIM attention and the fp baseline.

Counterpart of the JAX package's `core/attention.py`: the dense cache
(classic scalar fill or ragged per-slot lengths) and the paged pool with
its trash page, page copies, the page fetches and restores of a spill,
and page checksums; the ring caches of sliding-window layers.

Score: int8 QK^T, requantized to 8-bit score codes.  Softmax: LUT exp and a
two-phase normalization, in the shifted mode through the LUT softmax kernel
(`kernels/lut_softmax.py`: CUDA for CUDA tensors, its plain version on the
CPU).  AV: uint8 probabilities (with the V scales folded in) times int8 V.
Under the quantized ADC every 16-element partial sum of Score and AV passes
through the ADC, on a head-expanded cache.  Integer contractions are float64
products, exact for every operand range here (|sum| < 2^53) on the CPU and
the GPU alike (CUDA has no integer bmm).
"""
from __future__ import annotations

import dataclasses
import os
import zlib
from typing import Optional, Union

import numpy as np
import torch

from repro_torch.configs.base import LUTSoftmaxConfig, PIMConfig
from repro_torch.core import quant
from repro_torch.core.lut_softmax import lut_softmax_codes, probs_to_uint8
from repro_torch.kernels.lut_softmax import lut_softmax as _lut_softmax_kernel


@dataclasses.dataclass
class KVCache:
    """Preallocated int8 KV cache with per-(token, head) float32 scales.

    The planes are allocated once at their full length and every write
    updates them in place; `length` counts the tokens written so far.  A
    stacked cache carries a leading layer axis on every plane, and
    `layer(r)` is a view of layer r that writes through to it.  The planes
    are head-major (the reference stores (B, S, Hkv, ...)), so that the
    kernels' (B * Hkv, S, ...) operands are views of them, never copies.

    `length` is an int on the classic equal-length path, or a (B,) int32
    device tensor of per-slot fills in ragged (slot) mode, where 0 marks an
    empty slot.

    A ring (sliding-window) cache also carries `positions`, the absolute
    token position held in each slot (-1: empty), shared by the batch as
    in the reference; other caches have None there.
    """

    k_q: torch.Tensor      # ([R,] B, Hkv, S, Dh * kv_bits // 8) int8
    v_q: torch.Tensor      # ([R,] B, Hkv, S, Dh * kv_bits // 8) int8
    k_scale: torch.Tensor  # ([R,] B, Hkv, S) f32
    v_scale: torch.Tensor  # ([R,] B, Hkv, S) f32
    length: Union[int, torch.Tensor] = 0
    positions: Optional[torch.Tensor] = None  # ([R,] S) int32, ring only

    def layer(self, r: int) -> "KVCache":
        return KVCache(self.k_q[r], self.v_q[r], self.k_scale[r],
                       self.v_scale[r], self.length,
                       None if self.positions is None else self.positions[r])


def packed_head_dim(head_dim: int, kv_bits: int) -> int:
    """Stored last-dim width of the K/V planes: `head_dim` bytes at 8 bits,
    `head_dim // 2` (two 4-bit codes per byte) at 4."""
    assert kv_bits in (4, 8), kv_bits
    assert kv_bits == 8 or head_dim % 2 == 0, head_dim
    return head_dim * kv_bits // 8


def cache_kv_bits(stored_dim: int, head_dim: int) -> int:
    """The stored KV precision, read off the packed vs logical width."""
    return 4 if stored_dim * 2 == head_dim else 8


def init_kv_cache(batch: int, max_len: int, n_kv: int, head_dim: int,
                  kv_bits: int = 8, device=None, layers=None,
                  ragged: bool = False, ring: bool = False) -> KVCache:
    """Zeroed cache of `max_len` tokens; `layers` adds the stacked axis,
    `ragged` the (B,) per-slot lengths (all 0: every slot empty) and
    `ring` the slot positions of a ring cache (all -1)."""
    dhp = packed_head_dim(head_dim, kv_bits)
    lead = () if layers is None else (layers,)
    z = dict(device=device)
    return KVCache(
        k_q=torch.zeros(lead + (batch, n_kv, max_len, dhp), dtype=torch.int8, **z),
        v_q=torch.zeros(lead + (batch, n_kv, max_len, dhp), dtype=torch.int8, **z),
        k_scale=torch.zeros(lead + (batch, n_kv, max_len), dtype=torch.float32, **z),
        v_scale=torch.zeros(lead + (batch, n_kv, max_len), dtype=torch.float32, **z),
        length=torch.zeros(batch, dtype=torch.int32, **z) if ragged else 0,
        positions=torch.full(lead + (max_len,), -1, dtype=torch.int32, **z)
        if ring else None,
    )


# ---------------------------------------------------------------------------
# paged KV cache: a global pool of fixed-size pages + per-slot page tables
# ---------------------------------------------------------------------------
TRASH_PAGE = 0
"""Physical page 0 is the write sink for invalid destinations (tokens past
a row's `seq_lens`, or positions whose page-table entry is unallocated).
The allocator never hands it out and no slot's `kv_len` reaches into it,
so what lands there is never read."""


@dataclasses.dataclass
class PagedKVCache:
    """int8 KV pool of `num_pages` pages of `page_size` tokens each, in the
    reference's layout: (P, page_size, Hkv, Dh[/2]) int8 K/V with
    (P, page_size, Hkv) float32 scales.  Slots own pages through rows of a
    (B, max_pages) int32 page table (-1 = unallocated) that travels beside
    the pool.  The kernels read a head inside a page row in place (row
    stride Hkv * Dh[/2]), so no step transposes or copies the pool.  A
    stacked pool carries a leading layer axis, and `layer(r)` is a view."""

    k_q: torch.Tensor      # ([R,] P, page_size, Hkv, Dh * kv_bits // 8) int8
    v_q: torch.Tensor      # ([R,] P, page_size, Hkv, Dh * kv_bits // 8) int8
    k_scale: torch.Tensor  # ([R,] P, page_size, Hkv) f32
    v_scale: torch.Tensor  # ([R,] P, page_size, Hkv) f32

    def layer(self, r: int) -> "PagedKVCache":
        return PagedKVCache(self.k_q[r], self.v_q[r], self.k_scale[r],
                            self.v_scale[r])

    @property
    def num_pages(self) -> int:
        return self.k_q.shape[-4]

    @property
    def page_size(self) -> int:
        return self.k_q.shape[-3]


def init_paged_kv_cache(num_pages: int, page_size: int, n_kv: int,
                        head_dim: int, kv_bits: int = 8, device=None,
                        layers=None) -> PagedKVCache:
    """Zeroed pool of `num_pages` pages (page 0 reserved as the trash
    page); `layers` adds the stacked axis."""
    dhp = packed_head_dim(head_dim, kv_bits)
    lead = () if layers is None else (layers,)
    shape = lead + (num_pages, page_size, n_kv)
    z = dict(device=device)
    return PagedKVCache(
        k_q=torch.zeros(shape + (dhp,), dtype=torch.int8, **z),
        v_q=torch.zeros(shape + (dhp,), dtype=torch.int8, **z),
        k_scale=torch.zeros(shape, dtype=torch.float32, **z),
        v_scale=torch.zeros(shape, dtype=torch.float32, **z),
    )


def paged_cache_write(pool: PagedKVCache, k: torch.Tensor, v: torch.Tensor,
                      pos: torch.Tensor, cfg: PIMConfig,
                      page_table: torch.Tensor,
                      seq_lens: Optional[torch.Tensor] = None) -> PagedKVCache:
    """Write (B, S, Hkv, Dh) K/V through the page table, in place: row b's
    token i lands in page `page_table[b, (pos_b + i) // page_size]` at
    offset `(pos_b + i) % page_size`.  Tokens past a row's `seq_lens` and
    tokens whose table entry is unallocated go to `TRASH_PAGE`: a stray
    write here would clobber a page of another slot."""
    B, S = k.shape[:2]
    ps = pool.page_size
    n_tables = page_table.shape[1]
    kv_bits = cache_kv_bits(pool.k_q.shape[-1], k.shape[-1])
    k_q, v_q, ks, vs = quantize_kv(k, v, cfg, kv_bits)
    logical = pos.long()[:, None] + torch.arange(S, device=k.device)  # (B, S)
    valid = logical < n_tables * ps
    if seq_lens is not None:
        valid = valid & (torch.arange(S, device=k.device)
                         < seq_lens.long()[:, None])
    page_idx = torch.clamp(logical // ps, 0, n_tables - 1)
    pid = torch.gather(page_table.long(), 1, page_idx)
    pid = torch.where(valid & (pid > TRASH_PAGE), pid, TRASH_PAGE)
    slot = logical % ps
    pool.k_q[pid, slot] = k_q
    pool.v_q[pid, slot] = v_q
    pool.k_scale[pid, slot] = ks
    pool.v_scale[pid, slot] = vs
    return pool


def paged_gather(pool: PagedKVCache, page_table: torch.Tensor,
                 kv_len: torch.Tensor) -> KVCache:
    """A slot-dense `KVCache` copy of the pool: row b is row b of the page
    table, page after page (unallocated entries read the trash page, which
    lies past `kv_len`).  The behavioral reference of the paged path: run
    through `pim_attention` it equals a dense slot cache holding the same
    tokens bit for bit, since masked positions contribute exact zeros."""
    B, n = page_table.shape
    ps, Hkv, Dhk = pool.page_size, pool.k_q.shape[-2], pool.k_q.shape[-1]
    pid = torch.clamp(page_table.long(), 0, pool.num_pages - 1)

    def dense(x, *tail):
        return x[pid].reshape((B, n * ps, Hkv) + tail).transpose(1, 2
                                                                 ).contiguous()

    return KVCache(dense(pool.k_q, Dhk), dense(pool.v_q, Dhk),
                   dense(pool.k_scale), dense(pool.v_scale),
                   torch.as_tensor(kv_len, dtype=torch.int32,
                                   device=page_table.device).expand(B))


def copy_pages(pool: PagedKVCache, src: torch.Tensor, dst: torch.Tensor,
               page_axis: int = 0) -> PagedKVCache:
    """Copy whole pages inside the pool, in place: page `dst[i]` becomes a
    bit-exact copy of page `src[i]` in K, V and both scale planes, at any
    KV precision.  The device half of copy-on-write: the scheduler copies a
    shared page into a fresh one before pointing a slot's table entry at
    it, so the shared original is never written.  `page_axis` is 1 for
    layer-stacked pools.  Every source page is read before any destination
    is written (one gather, then one indexed copy per plane)."""
    src = torch.as_tensor(src, device=pool.k_q.device).long()
    dst = torch.as_tensor(dst, device=pool.k_q.device).long()
    for plane in (pool.k_q, pool.v_q, pool.k_scale, pool.v_scale):
        plane.index_copy_(page_axis, dst, plane.index_select(page_axis, src))
    return pool


def fetch_pages(pool: PagedKVCache, pages: torch.Tensor,
                page_axis: int = 0) -> PagedKVCache:
    """Gather whole pages out of the pool: page i of the result is a
    bit-exact copy of pool page `pages[i]` (K, V and both scale planes), in
    new storage, so nothing of it aliases the pool.  The device half of a
    spill: the scheduler copies a victim slot's private pages to host
    memory instead of recomputing them later.  `page_axis` is 1 for
    layer-stacked pools; entries may repeat (`TRASH_PAGE` padding)."""
    pages = torch.as_tensor(pages, device=pool.k_q.device).long()
    return PagedKVCache(*[p.index_select(page_axis, pages) for p in
                          (pool.k_q, pool.v_q, pool.k_scale, pool.v_scale)])


def restore_pages(pool: PagedKVCache, pages: torch.Tensor,
                  data: PagedKVCache, page_axis: int = 0) -> PagedKVCache:
    """Scatter fetched pages back, in place: pool page `pages[i]` becomes a
    bit-exact copy of `data` page i, the inverse of `fetch_pages`.  The
    destinations are fresh pages, plus `TRASH_PAGE` padding lanes whose
    writes land in the sink.  `data` is moved to the pool's device."""
    pages = torch.as_tensor(pages, device=pool.k_q.device).long()
    for plane, d in zip((pool.k_q, pool.v_q, pool.k_scale, pool.v_scale),
                        (data.k_q, data.v_q, data.k_scale, data.v_scale)):
        plane.index_copy_(page_axis, pages, d.to(plane.device))
    return pool


def page_checksums(pool: PagedKVCache, pages, page_axis: int = 0,
                   seeds=None) -> np.ndarray:
    """Host crc32 of each listed page's stored bytes (C order), chained
    across the four pool fields in field order, as the reference computes
    them: on the live pool `pages` are page ids, on a fetched host tree
    positions.  The codes are stored at their width, so the crc covers
    4-bit pages as stored.  `seeds` chains onto earlier per-page crcs, so
    a cache of many pools folds every layer into one crc a page.  Returns
    uint32[len(pages)]."""
    pages = np.asarray(pages, dtype=np.int64)
    crcs = (np.zeros(pages.shape[0], dtype=np.uint32) if seeds is None
            else np.asarray(seeds, dtype=np.uint32).copy())
    for plane in (pool.k_q, pool.v_q, pool.k_scale, pool.v_scale):
        taken = plane.index_select(
            page_axis, torch.from_numpy(pages).to(plane.device)).cpu().numpy()
        for i in range(pages.shape[0]):
            page = np.ascontiguousarray(np.take(taken, i, axis=page_axis))
            crcs[i] = zlib.crc32(page.tobytes(), int(crcs[i])) & 0xFFFFFFFF
    return crcs


def quantize_kv(k: torch.Tensor, v: torch.Tensor, cfg: PIMConfig,
                kv_bits: int = 8):
    """Quantize-on-write per (token, kv head).  The scales are computed in
    the dtype of k/v and only then cast to float32, as in the reference."""
    k_scale = quant.symmetric_max_scale(k, cfg.input_bits, axis=-1)
    v_scale = quant.symmetric_max_scale(v, cfg.input_bits, axis=-1)
    if kv_bits == 4:
        k_q = quant.kv4_encode(k, k_scale)
        v_q = quant.kv4_encode(v, v_scale)
    else:
        k_q = quant.quantize(k, k_scale, cfg.input_bits)
        v_q = quant.quantize(v, v_scale, cfg.input_bits)
    return k_q, v_q, k_scale[..., 0].float(), v_scale[..., 0].float()


def cache_write(cache: KVCache, k: torch.Tensor, v: torch.Tensor, pos: int,
                cfg: PIMConfig) -> KVCache:
    """Write new (B, S, Hkv, Dh) K/V at positions [pos, pos + S) in place
    (the paper's K-write dataflow) and advance `length` to pos + S."""
    S = k.shape[1]
    if pos < 0 or pos + S > cache.k_q.shape[2]:
        raise ValueError(f"cache write [{pos}, {pos + S}) outside a cache of "
                         f"{cache.k_q.shape[2]} tokens")
    kv_bits = cache_kv_bits(cache.k_q.shape[-1], k.shape[-1])
    k_q, v_q, ks, vs = quantize_kv(k, v, cfg, kv_bits)
    cache.k_q[:, :, pos:pos + S] = k_q.transpose(1, 2)
    cache.v_q[:, :, pos:pos + S] = v_q.transpose(1, 2)
    cache.k_scale[:, :, pos:pos + S] = ks.transpose(1, 2)
    cache.v_scale[:, :, pos:pos + S] = vs.transpose(1, 2)
    cache.length = pos + S
    return cache


def cache_write_ring(cache: KVCache, k: torch.Tensor, v: torch.Tensor,
                     offset: int, cfg: PIMConfig) -> KVCache:
    """Ring write of a sliding-window layer, in place: the token at
    absolute position p lands in slot p mod W (W the cache's length).  Of
    more than W new tokens only the last W are written (the earlier ones
    would be overwritten anyway).  `length` becomes offset + S and the
    slots' positions are recorded.  Ring caches are int8."""
    W = cache.k_q.shape[2]
    S = k.shape[1]
    keep = min(S, W)
    k, v = k[:, S - keep:], v[:, S - keep:]
    abs_pos = offset + S - keep + torch.arange(keep, device=k.device)
    slots = torch.remainder(abs_pos, W)
    k_q, v_q, ks, vs = quantize_kv(k, v, cfg)
    cache.k_q[:, :, slots] = k_q.transpose(1, 2)
    cache.v_q[:, :, slots] = v_q.transpose(1, 2)
    cache.k_scale[:, :, slots] = ks.transpose(1, 2)
    cache.v_scale[:, :, slots] = vs.transpose(1, 2)
    cache.positions[slots] = abs_pos.to(torch.int32)
    cache.length = offset + S
    return cache


DEBUG_CACHE_WRITES = bool(int(os.environ.get("REPRO_DEBUG_CACHE_WRITES", "0")))
"""When set (or `debug=True` is passed), `cache_write_ragged` raises on rows
whose valid tokens would not fit the buffer instead of dropping them."""


def cache_write_ragged(cache: KVCache, k: torch.Tensor, v: torch.Tensor,
                       pos: torch.Tensor, cfg: PIMConfig,
                       seq_lens: Optional[torch.Tensor] = None,
                       debug: Optional[bool] = None) -> KVCache:
    """Per-slot write in place: row b writes its S tokens at positions
    [pos_b, pos_b + S), and its length becomes pos_b + seq_lens_b (default
    S), capped at max_len.  Padding past `seq_lens` is written but never
    advertised; a row with seq_lens 0 keeps length pos.

    Drop mode, as in the reference: tokens whose position falls at or past
    max_len vanish and the in-bounds prefix of the row is still written.
    With `debug` (or REPRO_DEBUG_CACHE_WRITES=1) an overflow raises
    ValueError before any write; that check reads `pos` on the host.

    No host sync otherwise: each row writes the in-bounds window
    [start_b, start_b + S) with start_b = min(pos_b, max_len - S), whose
    leading pos_b - start_b entries get their own current contents back."""
    B, S = k.shape[:2]
    max_len = cache.k_q.shape[2]
    if S > max_len:
        raise ValueError(f"a {S}-token ragged write exceeds the {max_len}-"
                         "token cache")
    pos = pos.long()
    end = pos + (S if seq_lens is None else seq_lens.long())
    if DEBUG_CACHE_WRITES if debug is None else debug:
        bad = torch.nonzero(end > max_len).flatten().tolist()
        if bad:
            raise ValueError(
                f"cache_write_ragged overflow: rows {bad} write past "
                f"max_len={max_len} (pos={pos[bad].tolist()}, "
                f"end={end[bad].tolist()}); tokens beyond the buffer are "
                "dropped and `length` is capped, pass debug=False to accept "
                "the truncation contract")
    kv_bits = cache_kv_bits(cache.k_q.shape[-1], k.shape[-1])
    k_q, v_q, ks, vs = quantize_kv(k, v, cfg, kv_bits)
    j = torch.arange(S, device=k.device)
    start = torch.clamp(pos, max=max_len - S)
    cols = start[:, None] + j                                  # (B, S)
    shift = (pos - start)[:, None]
    src = torch.clamp(j - shift, min=0)                        # (B, S)
    keep_old = j < shift                                       # (B, S)
    rows = torch.arange(B, device=k.device)[:, None]
    for plane, new in ((cache.k_q, k_q), (cache.v_q, v_q),
                       (cache.k_scale, ks), (cache.v_scale, vs)):
        tail = (1,) * (new.dim() - 2)
        new = torch.gather(new, 1, src.view(B, S, *tail).expand(new.shape))
        old = plane[rows, :, cols]                             # (B, S, Hkv, ...)
        plane[rows, :, cols] = torch.where(keep_old.view(B, S, *tail), old, new)
    cache.length = torch.clamp(end, max=max_len).to(torch.int32)
    return cache


def expected_kv_block_iters(
    q_len: int, k_len: int, q_offset: int, block_q: int, block_k: int,
    causal: bool = True, window: int = 0, kv_valid_len: int | None = None,
    q_valid_len: int | None = None,
) -> int:
    """Analytic count of the KV-block iterations one head needs after grid
    pruning (the kernels' `return_iters` probes are held to it).  Block
    (qi, ki) counts unless it lies entirely above the causal diagonal,
    beyond `kv_valid_len` or outside `window`; q blocks at or past
    `q_valid_len` are skipped.  Decode and verify launches are the
    `block_q == q_len` case."""
    kv_valid_len = k_len if kv_valid_len is None else kv_valid_len
    q_valid_len = q_len if q_valid_len is None else q_valid_len
    n_q = -(-q_len // block_q)
    n_k = -(-k_len // block_k)
    count = 0
    for qi in range(n_q):
        if qi * block_q >= q_valid_len:
            continue
        q_lo = q_offset + qi * block_q
        q_hi = q_offset + min((qi + 1) * block_q, q_valid_len) - 1
        for ki in range(n_k):
            k_start = ki * block_k
            if k_start >= kv_valid_len:
                continue
            if causal and k_start > q_hi:
                continue
            if window and k_start + block_k - 1 <= q_lo - window:
                continue
            count += 1
    return count


_PIM_ATTN_CHUNK = 512


def _int_einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact integer contraction, returned as float32 (the reference casts
    its int32 result the same way)."""
    return torch.einsum(eq, a.double(), b.double()).float()


def _group(x: torch.Tensor, dim: int, g: int) -> torch.Tensor:
    """Zero-pad `dim` to a multiple of g and split it into (size / g, g)."""
    rem = (-x.shape[dim]) % g
    if rem:
        pad = [0, 0] * (x.dim() - 1 - dim) + [0, rem]
        x = torch.nn.functional.pad(x, pad)
    return x.unflatten(dim, (x.shape[dim] // g, g))


def pim_scores_int(q_q: torch.Tensor, k_q: torch.Tensor,
                   cfg: PIMConfig) -> torch.Tensor:
    """int8 QK^T through the ADC: (B, Sq, H, Dh) x (B, Sk, H, Dh) ->
    (B, H, Sq, Sk) on the ADC grid (each 16-element group of the head dim is
    one analog step).  The ideal mode's GQA-grouped product is inline in
    `_pim_attend_block`."""
    g = cfg.wordline_group
    psum = torch.einsum("bqhge,bkhge->bhqkg", _group(q_q, 3, g).double(),
                        _group(k_q, 3, g).double())
    return quant.adc_transfer(psum, cfg.adc_bits,
                              quant.adc_full_range(cfg)).sum(-1)


def pim_av_int(p_u8: torch.Tensor, v_q: torch.Tensor,
               cfg: PIMConfig) -> torch.Tensor:
    """uint8 probabilities x int8 V through the ADC: (B, H, Sq, Sk) x
    (B, Sk, H, Dh) -> (B, Sq, H, Dh).  V is stationary along the sequence
    (word-line) axis, so the ADC groups run over Sk."""
    g = cfg.wordline_group
    psum = torch.einsum("bhqge,bgehd->bqhdg", _group(p_u8, 3, g).double(),
                        _group(v_q, 1, g).double())
    return quant.adc_transfer(psum, cfg.adc_bits,
                              quant.adc_full_range(cfg)).sum(-1)


def _pim_attend_block(qb, q_pos, k_q, ks_bh, v_q, vs_bh, vs_cum, kv_len,
                      pim_cfg: PIMConfig, lut_cfg: LUTSoftmaxConfig,
                      causal: bool, window: int):
    """One query block of Score -> LUT softmax -> AV, GQA-grouped: q is
    viewed as (B, cq, Hkv, G, Dh) against the raw int8 cache.  The
    quantized ADC is the G == 1 case of the same pipeline: the caller
    head-expands the cache, and Score and AV go through `pim_scores_int` /
    `pim_av_int`.

    qb: (B, cq, H, Dh); q_pos: (B, cq) absolute positions; kv_len: (B,)
    valid cache lengths; k_q/v_q: (B, Sk, Hkv, Dh) int8; ks_bh/vs_bh/vs_cum:
    (B, Hkv, Sk) scales."""
    B, cq, H, Dh = qb.shape
    Sk, Hkv = k_q.shape[1], k_q.shape[2]
    G = H // Hkv
    ideal = pim_cfg.adc_mode == "ideal"
    if not (ideal or G == 1):
        raise ValueError("the quantized ADC needs a head-expanded cache")
    sm_scale = 1.0 / (Dh ** 0.5)

    # Score: int8 QK^T, then the requantize to the 8-bit score port
    q_scale = quant.symmetric_max_scale(qb, pim_cfg.input_bits, axis=-1)
    q_q = quant.quantize(qb, q_scale, pim_cfg.input_bits)
    if ideal:
        qg = q_q.reshape(B, cq, Hkv, G, Dh)
        s_int = _int_einsum("bqhgd,bkhd->bhgqk", qg, k_q)
    else:
        s_int = pim_scores_int(q_q, k_q, pim_cfg)[:, :, None]
    qs = q_scale[..., 0].float().reshape(B, cq, Hkv, G).permute(0, 2, 3, 1)
    s_real = (s_int * qs[..., None] * ks_bh[:, :, None, None, :]) * sm_scale
    qmax = (1 << (lut_cfg.input_bits - 1)) - 1
    s_codes = torch.clamp(torch.round(s_real / lut_cfg.score_scale),
                          -qmax - 1, qmax).to(torch.int32)

    # Softmax: LUT + two-phase normalization
    k_pos = torch.arange(Sk, device=qb.device)[None, None, :]
    mask = k_pos < kv_len[:, None, None]                   # (B, cq, Sk)
    if causal:
        mask = mask & (k_pos <= q_pos[:, :, None])
    if window:
        mask = mask & (k_pos > q_pos[:, :, None] - window)
    mask = mask[:, None, None].expand(s_codes.shape)     # as the reference
    if lut_cfg.mode == "shifted":
        codes = _lut_softmax_kernel(s_codes, mask, lut_cfg)
    else:
        codes = lut_softmax_codes(s_codes, lut_cfg, mask=mask)
    p_u8 = probs_to_uint8(codes, lut_cfg)                  # (B,Hkv,G,cq,Sk)

    # AV: per-token V scales folded into the probabilities before the array
    if causal:
        # running max of the V scales up to each query (never a future token)
        idx = torch.clamp(q_pos, 0, Sk - 1)[:, None, :].expand(B, Hkv, cq)
        s_fold = torch.clamp_min(torch.gather(vs_cum, 2, idx), 1e-8)
    else:
        s_fold = torch.clamp_min(vs_bh.amax(dim=-1, keepdim=True), 1e-8
                                 ).expand(B, Hkv, cq)
    p255 = torch.clamp(
        torch.round(p_u8.float() * vs_bh[:, :, None, None, :]
                    / s_fold[:, :, None, :, None]), 0, 255)
    if ideal:
        o_int = _int_einsum("bhgqk,bkhd->bqhgd", p255, v_q)
    else:
        o_int = pim_av_int(p255[:, :, 0], v_q, pim_cfg)[:, :, :, None]
    o = (o_int * s_fold.permute(0, 2, 1)[:, :, :, None, None]) * (2.0 ** -8)
    return o.reshape(B, cq, H, Dh)


def pim_attention(q: torch.Tensor, cache: KVCache, pim_cfg: PIMConfig,
                  lut_cfg: LUTSoftmaxConfig, q_offset, causal: bool = True,
                  window: int = 0, out_dtype=torch.bfloat16) -> torch.Tensor:
    """Paper-faithful quantized attention over the int8 KV cache.

    q: (B, Sq, H, Dh) float; `q_offset` and `cache.length` are scalars or
    (B,) vectors.  Query-chunked like the reference (the normalization is
    exact per row, so chunking changes nothing but the working set)."""
    B, Sq, H, Dh = q.shape
    k_q, v_q = cache.k_q.transpose(1, 2), cache.v_q.transpose(1, 2)
    if cache_kv_bits(k_q.shape[-1], Dh) == 4:
        # 4-bit storage decodes to exact int8 levels on the same scale grid
        k_q, v_q = quant.kv4_decode_int8(k_q), quant.kv4_decode_int8(v_q)
    dev = q.device
    q_off = torch.as_tensor(q_offset, dtype=torch.int64, device=dev
                            ).reshape(-1).expand(B)
    kv_len = torch.as_tensor(cache.length, dtype=torch.int64, device=dev
                             ).reshape(-1).expand(B)
    ks_bh, vs_bh = cache.k_scale, cache.v_scale            # (B, Hkv, Sk)
    if pim_cfg.adc_mode != "ideal":
        # head-expand, so that the G == 1 block routes every contraction
        # through the ADC
        q_per_kv = H // k_q.shape[2]
        k_q, v_q = _expand_kv(k_q, q_per_kv), _expand_kv(v_q, q_per_kv)
        ks_bh = torch.repeat_interleave(ks_bh, q_per_kv, dim=1)
        vs_bh = torch.repeat_interleave(vs_bh, q_per_kv, dim=1)
    vs_cum = torch.cummax(vs_bh, dim=2).values if causal else vs_bh

    cq = _PIM_ATTN_CHUNK
    chunks = [(0, Sq)] if (Sq <= cq or Sq % cq) else \
        [(c, c + cq) for c in range(0, Sq, cq)]
    outs = []
    for lo, hi in chunks:
        q_pos = q_off[:, None] + torch.arange(lo, hi, device=dev)[None, :]
        outs.append(_pim_attend_block(q[:, lo:hi], q_pos, k_q, ks_bh, v_q,
                                      vs_bh, vs_cum, kv_len, pim_cfg, lut_cfg,
                                      causal, window))
    return torch.cat(outs, dim=1).to(out_dtype)


def pim_attention_ring(q: torch.Tensor, cache: KVCache, pim_cfg: PIMConfig,
                       lut_cfg: LUTSoftmaxConfig, q_offset: int, window: int,
                       out_dtype=torch.bfloat16) -> torch.Tensor:
    """Paper-faithful quantized attention over a ring (sliding-window)
    cache: q (B, Sq, H, Dh) at absolute positions q_offset .. + Sq - 1.
    Slots are masked by their recorded positions, (pos >= 0) & (pos <= q)
    & (pos > q - window), so causality needs no slot order.  The V scales
    are folded against their maximum over the valid slots.  Under the
    ideal ADC the products are GQA-grouped (exact integers, as the
    reference's head-expanded ones); under the quantized ADC the cache is
    head-expanded and every contraction goes through the ADC.  The LUT
    softmax runs kernel 4 (shifted mode) on the broadcast slot mask."""
    B, Sq, H, Dh = q.shape
    Hkv = cache.k_q.shape[1]
    dev = q.device
    ideal = pim_cfg.adc_mode == "ideal"
    G = H // Hkv if ideal else 1
    k_q, v_q = cache.k_q, cache.v_q                        # (B, Hkv, Sk, Dh)
    ks, vs = cache.k_scale, cache.v_scale                  # (B, Hkv, Sk)
    if not ideal:
        k_q, v_q = (torch.repeat_interleave(x, H // Hkv, dim=1)
                    for x in (k_q, v_q))
        ks, vs = (torch.repeat_interleave(x, H // Hkv, dim=1)
                  for x in (ks, vs))
    Hg = k_q.shape[1]
    sm_scale = 1.0 / (Dh ** 0.5)
    q_scale = quant.symmetric_max_scale(q, pim_cfg.input_bits, axis=-1)
    q_q = quant.quantize(q, q_scale, pim_cfg.input_bits)
    if ideal:
        s_int = _int_einsum("bqhgd,bhkd->bhgqk",
                            q_q.reshape(B, Sq, Hkv, G, Dh), k_q)
    else:
        s_int = pim_scores_int(q_q, k_q.transpose(1, 2), pim_cfg)[:, :, None]
    qs = q_scale[..., 0].float().reshape(B, Sq, Hg, G).permute(0, 2, 3, 1)
    s_real = (s_int * qs[..., None] * ks[:, :, None, None, :]) * sm_scale
    qmax = (1 << (lut_cfg.input_bits - 1)) - 1
    s_codes = torch.clamp(torch.round(s_real / lut_cfg.score_scale),
                          -qmax - 1, qmax).to(torch.int32)
    pos = cache.positions[None, :]                         # (1, Sk)
    q_pos = q_offset + torch.arange(Sq, device=dev)[:, None]
    mask = (pos >= 0) & (pos <= q_pos) & (pos > q_pos - window)  # (Sq, Sk)
    mask = mask.expand(s_codes.shape)
    if lut_cfg.mode == "shifted":
        codes = _lut_softmax_kernel(s_codes, mask, lut_cfg)
    else:
        codes = lut_softmax_codes(s_codes, lut_cfg, mask=mask)
    p_u8 = probs_to_uint8(codes, lut_cfg)                  # (B,Hg,G,Sq,Sk)
    valid = (cache.positions >= 0)[None, None]
    s_fold = torch.clamp_min(torch.where(valid, vs, 0.0).amax(dim=-1,
                                                              keepdim=True),
                             1e-8)                         # (B, Hg, 1)
    p_fold = torch.clamp(torch.round(
        p_u8.float() * (vs / s_fold)[:, :, None, None, :]), 0, 255)
    if ideal:
        o_int = _int_einsum("bhgqk,bhkd->bqhgd", p_fold, v_q)
    else:
        o_int = pim_av_int(p_fold[:, :, 0], v_q.transpose(1, 2),
                           pim_cfg)[:, :, :, None]
    o = (o_int * s_fold[:, None, :, :, None]) * (2.0 ** -8)
    return o.reshape(B, Sq, H, Dh).to(out_dtype)


def _expand_kv(x: torch.Tensor, q_per_kv: int) -> torch.Tensor:
    """(B, S, Hkv, ...) -> (B, S, H, ...) by head-group broadcast (GQA)."""
    return x if q_per_kv == 1 else torch.repeat_interleave(x, q_per_kv, dim=2)


_FP_ATTN_CHUNK = 512


def _fp_attend_block(qb, k, v, q_pos, causal, window, kv_valid_len, Dh):
    s = torch.einsum("bqhd,bkhd->bhqk", qb, k).float() / (Dh ** 0.5)
    k_pos = torch.arange(k.shape[1], device=qb.device)[None, :]
    mask = torch.ones(s.shape[-2:], dtype=torch.bool, device=qb.device)
    if causal:
        mask &= k_pos <= q_pos[:, None]
    if window:
        mask &= k_pos > q_pos[:, None] - window
    if kv_valid_len is not None:
        mask &= k_pos < kv_valid_len
    s = torch.where(mask[None, None], s, -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v)


def fp_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 q_offset: int = 0, causal: bool = True, window: int = 0,
                 kv_valid_len=None, out_dtype=None) -> torch.Tensor:
    """fp32-softmax attention: the accuracy baseline of the PIM numerics."""
    B, Sq, H, Dh = q.shape
    k = _expand_kv(k, H // k.shape[2])
    v = _expand_kv(v, H // v.shape[2])
    cq = _FP_ATTN_CHUNK
    chunks = [(0, Sq)] if (Sq <= cq or Sq % cq) else \
        [(c, c + cq) for c in range(0, Sq, cq)]
    outs = []
    for lo, hi in chunks:
        q_pos = q_offset + torch.arange(lo, hi, device=q.device)
        outs.append(_fp_attend_block(q[:, lo:hi], k, v, q_pos, causal,
                                     window, kv_valid_len, Dh))
    return torch.cat(outs, dim=1).to(out_dtype or q.dtype)
