"""Split-K flash decode for PIM attention: the CUDA kernel's wrapper, its
launch plan, its LUT-domain combine and the plain PyTorch version.

Counterpart of the JAX package's `kernels/pim_decode.py`
(`pim_decode_pallas`).  The kernel is `csrc/pim_decode.cu`; its header
says what it computes, what bounds it on the card and how.

`pim_decode` launches the kernel for CUDA tensors and runs the plain
version for CPU tensors, never one in place of the other.  The plain
version repeats the kernel's grid: the same row packing r = l * G + g, the
same range of needed partitions (`needed_range`), page walk and
per-partition partials, the same iteration map, and the same combine, which
runs the partitions in order with separately rounded multiply and add.
Rows are computed one at a time, so that a row's arithmetic never depends
on how many rows share the launch (verify rows stay bit-identical to
single-step decodes here too).
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import LUTSoftmaxConfig, PIMConfig
from repro_torch.core.lut_softmax import build_exp_table
from repro_torch.core.quant import kv4_levels
from repro_torch.kernels import _build
from repro_torch.kernels.pim_attention import (
    HEAD_DIMS, MAX_SMEM, _NEG, _check, cdiv, check_launch_operands, kv_blocks,
    scalar_table)
from repro_torch.kernels.pim_matmul import _sm_count

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "pim_decode_launch": [_P] * 7 + [_I] + [_P] * 7 + [_I] * 15 + [_F] * 4
                         + [_P],
    "pim_decode_smem_bytes": [_I] * 5,
}
# the kernel's constants (csrc/pim_decode.cu)
THREADS = 256
WARPS = THREADS // 32
KV_ROWS = 128          # KV rows per cp.async stage
STAGES = 3             # ring slots
KEYS = KV_ROWS // WARPS  # keys a warp owns in a stage
TILE_ROWS = (2, 4, 8)  # packed q rows a CTA takes
# CTAs the grid aims at per SM, over all row tiles
CTAS_PER_SM = 2


def blocks_a_unit(block_k: int) -> int:
    """Partitions of one unit of the kernel's walk: blocks of 16, 32 or 64
    rows are packed 128 / block_k to a 128-row stage; any other block_k is
    a unit of its own, of cdiv(block_k, 128) stages."""
    return KV_ROWS // block_k if block_k in (16, 32, 64) else 1


def unit_rows(block_k: int) -> int:
    """KV rows a unit stages: 128 for packed blocks, else block_k rounded
    up to whole stages (the rows past block_k zero-filled and masked)."""
    return KV_ROWS if blocks_a_unit(block_k) > 1 else cdiv(block_k, KV_ROWS) * KV_ROWS


def rec_bytes(rows: int, dh: int) -> int:
    """Bytes of one partition's partial record: m, den and acc of `rows`."""
    return rows * (dh + 2) * 4


def smem_bytes(rows: int, dh: int, dsplit: int, block_k: int, n_pt: int) -> int:
    """The kernel's dynamic shared memory (csrc/pim_decode.cu `layout`);
    `n_pt` is the page-table width of a paged launch, 0 for a dense one."""
    def a16(x):
        return (x + 15) // 16 * 16
    unit, nbu = unit_rows(block_k), blocks_a_unit(block_k)
    return (256 * 4 + a16(rows * 4) + 16 * (dh + 16) + 16 + a16(rows * 4)
            + a16(n_pt * 4) + a16(2 * nbu * rows * 4) + a16(unit * rows * 2)
            + WARPS * KEYS * rows * 4 + WARPS * rows * (dh // dsplit + 1) * 4
            + STAGES * (KV_ROWS * (dh + 16) + KV_ROWS * 4))


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """How the CUDA kernel covers a launch.  The R packed rows of a KV head
    fall into `row_tiles` tiles of `rows` rows (the last may be short), and
    the head dims into `dsplit` slices (each CTA scores over the whole head
    dim and takes Dh / dsplit of the output); each (KV head, row tile,
    slice) takes `chunks` CTAs, over which the needed range of partitions
    is cut into contiguous runs (`cta_runs`)."""
    rows: int
    row_tiles: int
    dsplit: int
    chunks: int
    smem: int


@functools.lru_cache(maxsize=None)
def launch_plan(R: int, dh: int, dhk: int, block_k: int, n_k: int, bhkv: int,
                paged: bool, sms: int) -> LaunchPlan:
    """The grid of a launch; raises for what the kernel does not take.
    `n_k` is the number of partitions of a KV head (the page-table width
    when `paged`); chunks bring the grid to about CTAS_PER_SM CTAs per SM
    where the heads have the partitions for it, and a grid that stays small
    (few heads of short int8 caches, as a classic decode step) is spread
    over slices of 32 head dims."""
    if dh not in HEAD_DIMS or dhk not in (dh, dh // 2) or dhk % 16:
        raise ValueError(f"the decode kernel takes head_dim {HEAD_DIMS} stored "
                         f"as int8 or 4 bits (a multiple of 16 bytes), not "
                         f"head_dim {dh} stored in {dhk} bytes")
    if block_k <= 0:
        raise ValueError(f"block_k {block_k} is not positive")
    rows = next(t for t in TILE_ROWS if t >= min(R, TILE_ROWS[-1]))
    row_tiles = cdiv(R, rows)
    tiles = bhkv * row_tiles
    n_units = cdiv(n_k, blocks_a_unit(block_k))
    want = CTAS_PER_SM * sms
    chunks = max(1, min(n_units, cdiv(want, tiles)))
    dsplit = dh // 32 if dhk == dh > 32 and tiles * chunks * dh // 32 <= want else 1
    if tiles * dsplit > 65535:
        raise ValueError(f"{bhkv} KV heads x {row_tiles} row tiles pass the "
                         "grid's 65535")
    smem = smem_bytes(rows, dh, dsplit, block_k, n_k if paged else 0)
    if smem > MAX_SMEM:
        raise ValueError(f"block_k {block_k}, {rows} rows, head_dim {dh} and "
                         f"{n_k} pages need {smem} bytes of shared memory")
    return LaunchPlan(rows=rows, row_tiles=row_tiles, dsplit=dsplit,
                      chunks=chunks, smem=smem)


def needed_range(q_pos, kv_len, q_len, Sq: int, block_k: int, n_k: int,
                 causal: bool, window: int):
    """(lo, hi): the KV partitions [lo, hi] that slots with queries at
    q_pos .. q_pos + min(q_len, Sq) - 1 over kv_len cached tokens can reach
    (empty where hi < lo), as `pim_attention.block_needed` decides them;
    (B,) int tensors in, (B,) tensors out.  In paged mode the unallocated
    pages inside the range are skipped as well."""
    n_valid = torch.clamp(q_len, max=Sq)
    q_hi = q_pos + n_valid - 1
    hi = torch.where(kv_len > 0, torch.clamp((kv_len - 1) // block_k,
                                             max=n_k - 1), -1)
    if causal:
        hi = torch.where(q_hi >= 0, torch.minimum(hi, q_hi // block_k), -1)
    lo = torch.zeros_like(hi)
    if window:
        t = q_pos - window + 1          # block ki is needed iff (ki + 1) * bk > t
        lo = torch.where(t > 0, t // block_k, 0)
    return lo, torch.where(q_len > 0, hi, -1)


def cta_runs(lo: int, hi: int, block_k: int, chunks: int
             ) -> List[Tuple[int, int]]:
    """The kernel's split of one tile's range [lo, hi] over its `chunks`
    CTAs: [(first unit, end unit)] of each CTA that runs (unit u holds
    partitions u * n .. u * n + n - 1, n = `blocks_a_unit(block_k)`)."""
    if hi < lo:
        return []
    nbu = blocks_a_unit(block_k)
    u0, u1 = lo // nbu, hi // nbu + 1
    per = cdiv(u1 - u0, chunks)
    return [(u, min(u + per, u1)) for u in range(u0, u1, per)]


_counters: Dict[torch.device, torch.Tensor] = {}
# When a list, every launch appends its (3, nb) int32 scalar table on the
# device (q_offset, kv_len, q_len), q's (BH, Sq, Dh) and whether it is
# causal: the served shapes of a run, read after it without a host sync
# during it.
SHAPES: Optional[list] = None


def _tile_counters(dev: torch.device, n: int) -> torch.Tensor:
    """At least `n` zeroed int32, one per row tile of a launch, which the
    kernel leaves zeroed.  One buffer per device: launches on one stream at
    a time share it."""
    c = _counters.get(dev)
    if c is None or c.numel() < n:
        c = _counters[dev] = torch.zeros(max(n, 1024), dtype=torch.int32,
                                         device=dev)
    return c


def pim_decode(q_q, q_scale, k_q, k_scale, v_q, v_scale, q_offset, kv_len,
               pim_cfg: PIMConfig = PIMConfig(),
               lut_cfg: LUTSoftmaxConfig = LUTSoftmaxConfig(),
               causal: bool = True, window: int = 0, block_k: int = 256,
               return_iters: bool = False,
               page_table: Optional[torch.Tensor] = None, q_len=None):
    """Split-K decode attention; returns (BH, Sq, Dh) float32, and with
    `return_iters` also the (BHkv, n_k_blocks) int32 map of the KV
    partitions that ran.

    Operands as in `pim_attention`.  Sq is 1, or k + 1 speculative verify
    positions: slot b's queries sit at q_offset[b] .. q_offset[b] +
    q_len[b] - 1 (q_len defaults to Sq; 0 runs no partition and returns
    zeros).  Rows past q_len are fully masked; callers slice them away.

    With `page_table`, K/V are the paged pool as in `pim_attention`: one
    partition is one page (block_k is the page size, the partitions are the
    table's n_tables entries), and an unallocated page runs nothing and adds
    an exact zero in the combine."""
    hkv = _check(q_q, q_scale, k_q, k_scale, v_q, v_scale, page_table)
    if q_q.is_cuda:
        return _decode(q_q, q_scale, k_q, k_scale, v_q, v_scale, q_offset,
                       kv_len, lut_cfg, causal, window, block_k,
                       return_iters, q_len, page_table, hkv, _launch)
    if q_q.device.type != "cpu":
        raise ValueError(f"no pim_decode kernel for {q_q.device}")
    return pim_decode_plain(q_q, q_scale, k_q, k_scale, v_q, v_scale,
                            q_offset, kv_len, pim_cfg, lut_cfg, causal,
                            window, block_k, return_iters, page_table, q_len)


def pim_decode_plain(q_q, q_scale, k_q, k_scale, v_q, v_scale, q_offset,
                     kv_len, pim_cfg: PIMConfig = PIMConfig(),
                     lut_cfg: LUTSoftmaxConfig = LUTSoftmaxConfig(),
                     causal: bool = True, window: int = 0, block_k: int = 256,
                     return_iters: bool = False,
                     page_table: Optional[torch.Tensor] = None, q_len=None):
    """The plain PyTorch version of `pim_decode`, on any device."""
    hkv = _check(q_q, q_scale, k_q, k_scale, v_q, v_scale, page_table)
    return _decode(q_q, q_scale, k_q, k_scale, v_q, v_scale, q_offset,
                   kv_len, lut_cfg, causal, window, block_k, return_iters,
                   q_len, page_table, hkv, _plain)


def _decode(q_q, q_scale, k_q, k_scale, v_q, v_scale, q_offset, kv_len,
            lut_cfg, causal, window, block_k, return_iters, q_len,
            page_table, hkv, impl):
    BH, Sq, Dh = q_q.shape
    paged = page_table is not None
    BHkv = page_table.shape[0] * hkv if paged else k_q.shape[0]
    scalars = scalar_table(q_offset, kv_len, Sq if q_len is None else q_len,
                           q_q.device, page_table.shape[0] if paged else 1)
    nb = scalars.shape[1]
    if BHkv % nb or (paged and nb != page_table.shape[0]):
        raise ValueError(f"{BHkv} KV rows do not split over {nb} sequences")
    if paged:
        block_k = k_q.shape[1]
    out, iters = impl(q_q, q_scale.float(), k_q, k_scale, v_q, v_scale,
                      page_table, scalars, lut_cfg, BH // BHkv, causal,
                      window, block_k)
    return (out, iters) if return_iters else out


def combine_plain(part_m, part_den, part_acc, lut_cfg: LUTSoftmaxConfig):
    """Stage 2 in the LUT domain: rescale partition p by
    table[m_glob - m_p] / 2^frac (0 for a skipped partition), in partition
    order.  (BHkv, nk, R[, Dh]) partials -> (BHkv, R, Dh)."""
    table, frac = build_exp_table(lut_cfg, part_m.device)
    m_glob = part_m.amax(dim=1, keepdim=True)
    d = torch.clamp(m_glob - part_m, 0, 255).long()
    resc = table.float()[d] / float(1 << frac)
    resc = torch.where(part_m <= _NEG / 2, 0.0, resc)
    den = torch.zeros_like(part_den[:, 0])
    acc = torch.zeros_like(part_acc[:, 0])
    for p in range(part_m.shape[1]):
        den = den + part_den[:, p] * resc[:, p]
        acc = acc + part_acc[:, p] * resc[:, p, :, None]
    return acc / torch.clamp_min(den, 1.0)[..., None]


def _plain(q_q, q_scale, k_q, k_scale, v_q, v_scale, page_table, scalars,
           lut_cfg, G, causal, window, bk):
    BH, Sq, Dh = q_q.shape
    BHkv, R = BH // G, Sq * G
    dev = q_q.device
    # pack the q heads of each KV group and the verify positions as rows
    # r = l * G + g of one tile per KV head
    qg = q_q.reshape(BHkv, G, Sq, Dh).transpose(1, 2).reshape(BHkv, R, Dh)
    qsg = q_scale.reshape(BHkv, G, Sq).transpose(1, 2).reshape(BHkv, R)
    rows = torch.arange(BHkv, device=dev)
    hkv_per_b = BHkv // scalars.shape[1]
    seq = rows // hkv_per_b
    head = rows if page_table is None else rows % hkv_per_b
    kv, ks, vv, vs, alloc = kv_blocks(k_q, k_scale, v_q, v_scale,
                                      page_table, seq, head, bk, Dh)
    n_k = kv.shape[1]
    vdeq = vv.float() * vs[..., None]

    sc = scalars.long()[:, seq]
    q_pos, kvl, ql = sc[0], sc[1], sc[2]                   # (BHkv,)
    n_valid = torch.clamp(ql, max=Sq)
    lo, hi = needed_range(q_pos, kvl, ql, Sq, bk, n_k, causal, window)
    k_idx = torch.arange(n_k, device=dev)
    needed = alloc & (k_idx >= lo[:, None]) & (k_idx <= hi[:, None])
    k_pos = (k_idx[:, None] * bk + torch.arange(bk, device=dev))[None]
    table, _ = build_exp_table(lut_cfg, dev)
    table = table.float()
    sm_scale = 1.0 / (Dh ** 0.5)
    qmax = float((1 << (lut_cfg.input_bits - 1)) - 1)
    kd = kv.double()

    part_m = torch.full((BHkv, n_k, R), _NEG, device=dev)
    part_den = torch.zeros((BHkv, n_k, R), device=dev)
    part_acc = torch.zeros((BHkv, n_k, R, Dh), device=dev)
    for r in range(R):
        l = r // G
        s_int = torch.einsum("bd,bnkd->bnk", qg[:, r].double(), kd).float()
        s_real = s_int * qsg[:, r, None, None] * ks * sm_scale
        codes = torch.clamp(torch.round(s_real / lut_cfg.score_scale),
                            -qmax - 1.0, qmax)
        pos = (q_pos + l)[:, None, None]
        mask = (k_pos < kvl[:, None, None]) & (l < n_valid)[:, None, None]
        if causal:
            mask = mask & (k_pos <= pos)
        if window:
            mask = mask & (k_pos > pos - window)
        codes = torch.where(mask, codes, _NEG)
        m = codes.amax(dim=-1)                             # (BHkv, n_k)
        e = torch.where(
            mask, table[torch.clamp(m[..., None] - codes, 0, 255).long()], 0.0)
        acc = torch.einsum("bnk,bnkd->bnd", e, vdeq)
        part_m[:, :, r] = torch.where(needed, m, _NEG)
        part_den[:, :, r] = torch.where(needed, e.sum(dim=-1), 0.0)
        part_acc[:, :, r] = torch.where(needed[..., None], acc, 0.0)
    out = combine_plain(part_m, part_den, part_acc, lut_cfg)
    out = out.reshape(BHkv, Sq, G, Dh).transpose(1, 2).reshape(BH, Sq, Dh)
    return out, needed.to(torch.int32)


def _lib():
    return _build.load("pim_decode", _SIGNATURES)


@functools.lru_cache(maxsize=None)
def _checked_plan(R, dh, dhk, block_k, n_k, bhkv, paged, index) -> LaunchPlan:
    """`launch_plan` on device `index`, its shared memory checked against
    the kernel's own layout once per shape."""
    plan = launch_plan(R, dh, dhk, block_k, n_k, bhkv, paged, _sm_count(index))
    if _lib().pim_decode_smem_bytes(plan.rows, dh, plan.dsplit, block_k,
                                    n_k if paged else 0) != plan.smem:
        raise RuntimeError("launch_plan's shared memory disagrees with the kernel's")
    return plan


def _launch(q_q, q_scale, k_q, k_scale, v_q, v_scale, page_table, scalars,
            lut_cfg, G, causal, window, bk):
    """One launch of the kernel: q is read, and the output written, in the
    (BH, Sq, Dh) layout, so a call runs one device kernel."""
    BH, Sq, Dh = q_q.shape
    Sk, Dhk = k_q.shape[1], k_q.shape[-1]
    dev = q_q.device
    BHkv = BH // G
    pt = None if page_table is None else page_table.contiguous()
    n_k = cdiv(Sk, bk) if pt is None else pt.shape[1]
    plan = _checked_plan(Sq * G, Dh, Dhk, bk, n_k, BHkv, pt is not None,
                         dev.index or 0)
    ops = [t.contiguous() for t in
           (q_q, q_scale, k_q, k_scale.float(), v_q, v_scale.float())]
    check_launch_operands(ops, Dhk)
    table, frac = build_exp_table(lut_cfg, dev)
    levels = kv4_levels(dev)
    tiles = BHkv * plan.row_tiles * plan.dsplit
    part = torch.empty(tiles * n_k * rec_bytes(plan.rows, Dh // plan.dsplit),
                       dtype=torch.uint8, device=dev)
    out = torch.empty((BH, Sq, Dh), dtype=torch.float32, device=dev)
    iters = torch.empty((BHkv, n_k), dtype=torch.int32, device=dev)
    err = _lib().pim_decode_launch(
        *[t.data_ptr() for t in ops], scalars.data_ptr(), scalars.shape[1],
        None if pt is None else pt.data_ptr(), table.data_ptr(),
        levels.data_ptr(), part.data_ptr(),
        _tile_counters(dev, tiles).data_ptr(), out.data_ptr(),
        iters.data_ptr(), BHkv, plan.row_tiles, plan.rows, plan.dsplit, plan.chunks, G,
        Sq, Dh, Dhk, Sk, bk, n_k, BHkv // scalars.shape[1], int(causal),
        int(window), 1.0 / (Dh ** 0.5), lut_cfg.score_scale,
        float((1 << (lut_cfg.input_bits - 1)) - 1), 1.0 / (1 << frac),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "pim_decode launch")
    _build.LAUNCHES["pim_decode"] += 1
    if SHAPES is not None:
        SHAPES.append((scalars, tuple(q_q.shape), bool(causal)))
    return out, iters
