"""Fused flash-style PIM attention (prefill): the CUDA kernel's wrapper and
its plain PyTorch version.

Counterpart of the JAX package's `kernels/pim_attention.py`
(`pim_attention_pallas`).  The kernel is `csrc/pim_attention.cu`; its
header says what it computes, what bounds it on the card and how.

`pim_attention` launches the kernel for CUDA tensors and runs
`pim_attention_plain` for CPU tensors; it never falls back from one to the
other.  The plain version walks the reference's grid: the same q and KV
blocks, page walk, block early-outs, online steps and iteration counts,
which the kernel takes in the same order (one online step per reference
block), so it is the kernel's reference on the card and the port's kernel
path on the CPU.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import torch

from repro_torch.configs.base import LUTSoftmaxConfig, PIMConfig
from repro_torch.core.lut_softmax import build_exp_table
from repro_torch.core.quant import kv4_decode_int8, kv4_levels
from repro_torch.kernels import _build

_NEG = float(-(1 << 24))

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "pim_attention_launch": [_P] * 7 + [_I] + [_P] * 5 + [_I] * 16
                            + [_F] * 4 + [_P],
    "pim_attention_smem_bytes": [_I] * 3,
}
# the largest dynamic shared memory a block may have on the H100
MAX_SMEM = 227 * 1024
# the kernel's constants (csrc/pim_attention.cu)
THREADS = 256
KV_ROWS = 64           # KV rows per cp.async stage
STAGES = 3             # ring slots
MAX_ACC = 32           # float32 accumulators a thread: rows * Dh <= 8192
HEAD_DIMS = (32, 64, 96, 128, 256)


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """How the CUDA kernel covers a launch.  A CTA takes one reference q
    block of `heads_per_cta` q heads of one KV group, stacked as `rows`
    MMA rows (heads_per_cta * block_q, padded); a group of q_per_kv heads
    takes `splits` CTAs.  The KV sequence is walked in units of `unit_rows`
    rows, `blocks_per_unit` reference blocks (one online step each), staged
    `KV_ROWS` rows at a time through `STAGES` ring slots."""
    rows: int
    heads_per_cta: int
    splits: int
    unit_rows: int
    blocks_per_unit: int
    smem: int

    def cta_heads(self, y: int, q_per_kv: int) -> range:
        """The q heads (rows of q_q) of the CTAs in grid column `y`."""
        first = (y // self.splits) * q_per_kv + (y % self.splits) * self.heads_per_cta
        return range(first, first + self.heads_per_cta)


def smem_bytes(rows: int, dh: int, block_k: int) -> int:
    """The kernel's dynamic shared memory (csrc/pim_attention.cu `layout`)."""
    unit = max(block_k, KV_ROWS)
    nbu = 1 if block_k >= KV_ROWS else KV_ROWS // block_k
    codes = (unit * (rows + 2) * 2 + 15) // 16 * 16
    return (256 * 4 + 3 * rows * 4 + 4 * nbu * rows * 4 + codes
            + KV_ROWS * rows * 4 + KV_ROWS * dh * 4
            + STAGES * (KV_ROWS * (dh + 16) + KV_ROWS * 4) + 16)


def launch_plan(dh: int, dhk: int, block_q: int, q_per_kv: int,
                block_k: int) -> LaunchPlan:
    """The CTA shape of a launch; raises for what the kernel does not take.
    Rows: the most heads of the group (a divisor of q_per_kv) whose
    padded rows times Dh fit MAX_ACC accumulators a thread; the rest of the
    group goes to further CTAs.  A stage holds whole reference blocks
    (block_k 8, 16 or 32) or a whole part of one (block_k a multiple of
    64)."""
    if dh not in HEAD_DIMS or dhk not in (dh, dh // 2) or dhk % 16:
        raise ValueError(f"the prefill kernel takes head_dim {HEAD_DIMS} stored "
                         f"as int8 or 4 bits (a multiple of 16 bytes), not "
                         f"head_dim {dh} stored in {dhk} bytes")
    if not (block_k % KV_ROWS == 0 or block_k in (8, 16, 32)) or block_k <= 0:
        raise ValueError(f"block_k {block_k} is neither 8, 16, 32 nor a "
                         f"multiple of {KV_ROWS}")
    if not 1 <= block_q <= 128:
        raise ValueError(f"block_q {block_q} is not in [1, 128]")

    def padded(n):
        return max(16, 1 << (n - 1).bit_length())

    hpc = max([h for h in range(1, q_per_kv + 1) if q_per_kv % h == 0
               and padded(h * block_q) <= 128
               and padded(h * block_q) * dh <= MAX_ACC * THREADS], default=1)
    rows = padded(hpc * block_q)
    if rows > 128 or rows * dh > MAX_ACC * THREADS:
        raise ValueError(f"block_q {block_q} x head_dim {dh} does not fit a CTA")
    smem = smem_bytes(rows, dh, block_k)
    if smem > MAX_SMEM:
        raise ValueError(f"block_k {block_k}, {rows} rows, head_dim {dh} need "
                         f"{smem} bytes of shared memory")
    return LaunchPlan(rows=rows, heads_per_cta=hpc, splits=q_per_kv // hpc,
                      unit_rows=max(block_k, KV_ROWS),
                      blocks_per_unit=max(1, KV_ROWS // block_k), smem=smem)


# When a list, every launch appends its (3, nb) int32 scalar table on the
# device (q_offset, kv_len, q_len), q's (BH, Sq, Dh) and whether it is
# causal: the served shapes of a run, read after it without a host sync
# during it.
SHAPES: Optional[list] = None


def scalar_table(q_offset, kv_len, q_len, device, nb: int = 1):
    """The (3, nb) int32 table [q_offset, kv_len, q_len] of a launch; each
    entry is an int or a (B,) tensor on `device`, and nb is at least B.

    On the card a (B,) entry must already be a device tensor: converting a
    host array here would copy it synchronously, once per layer."""
    vals = (q_offset, kv_len, q_len)
    if all(isinstance(x, int) for x in vals):
        # one asynchronous copy from pinned memory, no stream synchronize
        host = torch.tensor([[x] * nb for x in vals], dtype=torch.int32)
        if torch.device(device).type == "cuda":
            host = host.pin_memory()
        return host.to(device, non_blocking=True)
    cols = []
    for x in vals:
        if not isinstance(x, (int, torch.Tensor)):
            raise TypeError(f"launch scalars are ints or tensors, not {type(x)}")
        if isinstance(x, torch.Tensor) and x.device != torch.device(device):
            raise ValueError(f"launch scalars on {x.device}, operands on {device}")
        cols.append(torch.as_tensor(x, dtype=torch.int32, device=device
                                    ).reshape(-1))
    nb = max([nb] + [c.numel() for c in cols])
    return torch.stack([c.expand(nb) for c in cols]).contiguous()


def block_needed(k_start, block_k: int, q_lo, q_hi, kv_len, causal: bool,
                 window: int):
    """Can KV block [k_start, k_start + block_k) contribute to queries at
    absolute positions [q_lo, q_hi]?  (Any mix of ints and tensors.)"""
    needed = k_start < kv_len
    if causal:
        needed = needed & (k_start <= q_hi)
    if window:
        needed = needed & ((k_start + block_k - 1) > (q_lo - window))
    return needed


def kv_values(x: torch.Tensor, dh: int) -> torch.Tensor:
    """Stored K/V codes -> int8 values (4-bit planes decode to the levels)."""
    return kv4_decode_int8(x) if x.shape[-1] * 2 == dh else x


def kv_blocks(k_q, k_scale, v_q, v_scale, page_table, seq, head,
              bk: int, dh: int):
    """The plain versions' view of the KV operands: for N KV rows, row i
    being head `head[i]` of sequence `seq[i]`, returns int8 K and V values
    (N, n_k, bk, dh), their scales (N, n_k, bk) and the (N, n_k) map of
    allocated blocks.  Dense planes (B*Hkv, Sk, ...) are cut into blocks of
    bk (head is the flat KV row, rows past Sk are zero); a pool
    (P, page_size, Hkv, ...) is walked through `page_table[seq]`, one page
    per block (unallocated entries read page 0 and are marked)."""
    if page_table is None:
        n_k = cdiv(k_q.shape[1], bk)
        pk = n_k * bk - k_q.shape[1]
        f = torch.nn.functional

        def cut(x, *tail):
            x = f.pad(x, (0, 0) * len(tail) + (0, pk))[head]
            return x.reshape((len(head), n_k, bk) + tail)

        alloc = torch.ones((len(head), n_k), dtype=torch.bool,
                           device=k_q.device)
        return (cut(kv_values(k_q, dh), dh), cut(k_scale),
                cut(kv_values(v_q, dh), dh), cut(v_scale), alloc)
    pid = page_table.long()[seq]                           # (N, n_tables)
    alloc = pid >= 0
    pid, h = torch.clamp(pid, min=0), head[:, None]
    return (kv_values(k_q, dh)[pid, :, h], k_scale[pid, :, h],
            kv_values(v_q, dh)[pid, :, h], v_scale[pid, :, h], alloc)


def _check(q_q, q_scale, k_q, k_scale, v_q, v_scale, page_table):
    """Shapes, types and devices of a launch; returns the number of KV
    heads a sequence has in a paged launch (None for a dense one)."""
    BH, Sq, Dh = q_q.shape
    Dhk = k_q.shape[-1]
    if Dhk not in (Dh, Dh // 2) or v_q.shape != k_q.shape:
        raise ValueError(f"K/V {tuple(k_q.shape)} do not fit q {tuple(q_q.shape)}")
    if page_table is None:
        if k_q.dim() != 3:
            raise ValueError(f"dense K/V are (B*Hkv, Sk, Dh), got {tuple(k_q.shape)}")
        scale_shape, hkv, BHkv = k_q.shape[:2], None, k_q.shape[0]
    else:
        if k_q.dim() != 4:
            raise ValueError("a paged K/V pool is (P, page_size, Hkv, Dh), "
                             f"got {tuple(k_q.shape)}")
        if page_table.dim() != 2 or page_table.dtype != torch.int32:
            raise ValueError("the page table is a (B, n_tables) int32 tensor")
        scale_shape, hkv = k_q.shape[:3], k_q.shape[2]
        BHkv = page_table.shape[0] * hkv
    if BH % BHkv or q_scale.shape != (BH, Sq) or k_scale.shape != scale_shape \
            or v_scale.shape != scale_shape:
        raise ValueError("attention operand shapes disagree")
    ts = (q_q, q_scale, k_q, k_scale, v_q, v_scale) + (
        () if page_table is None else (page_table,))
    devs = {t.device for t in ts}
    if len(devs) != 1:
        raise ValueError(f"attention operands on several devices: {devs}")
    return hkv


def pim_attention(q_q, q_scale, k_q, k_scale, v_q, v_scale, q_offset, kv_len,
                  pim_cfg: PIMConfig = PIMConfig(),
                  lut_cfg: LUTSoftmaxConfig = LUTSoftmaxConfig(),
                  causal: bool = True, window: int = 0, block_q: int = 32,
                  block_k: int = 256, prune: bool = True,
                  return_iters: bool = False,
                  page_table: Optional[torch.Tensor] = None,
                  q_len=None):
    """Fused PIM attention; returns (BH, Sq, Dh) float32, and with
    `return_iters` also the (BH, n_q_blocks) int32 count of KV blocks each
    q block ran.

    q_q (BH, Sq, Dh) int8 with (BH, Sq) scales; K/V (BHkv, Sk, Dh) int8, or
    (BHkv, Sk, Dh / 2) packed 4-bit codes, with (BHkv, Sk) float32 scales.
    q head bh reads KV head bh // (BH / BHkv).  `q_offset`, `kv_len` and
    `q_len` (default Sq) are scalars or (B,) vectors: row b's query 0 sits
    at q_offset[b], its cache holds kv_len[b] tokens and q_len[b] of its
    queries are valid (q blocks past it run no KV block).  `block_q` is
    clamped to the 8-rounded Sq, as in the reference, so iteration counts
    compare block for block.

    With `page_table` ((B, n_tables) int32, -1 = unallocated), K/V are the
    paged pool itself, (P, page_size, Hkv, Dh[/2]) with (P, page_size, Hkv)
    scales: block_k is the page size, KV block ki of sequence b is page
    page_table[b, ki], and unallocated entries run no iteration."""
    hkv = _check(q_q, q_scale, k_q, k_scale, v_q, v_scale, page_table)
    if q_q.is_cuda:
        return _attention(q_q, q_scale, k_q, k_scale, v_q, v_scale, q_offset,
                          kv_len, lut_cfg, causal, window, block_q, block_k,
                          prune, return_iters, q_len, page_table, hkv,
                          _launch)
    if q_q.device.type != "cpu":
        raise ValueError(f"no pim_attention kernel for {q_q.device}")
    return pim_attention_plain(q_q, q_scale, k_q, k_scale, v_q, v_scale,
                               q_offset, kv_len, pim_cfg, lut_cfg, causal,
                               window, block_q, block_k, prune, return_iters,
                               page_table, q_len)


def pim_attention_plain(q_q, q_scale, k_q, k_scale, v_q, v_scale, q_offset,
                        kv_len, pim_cfg: PIMConfig = PIMConfig(),
                        lut_cfg: LUTSoftmaxConfig = LUTSoftmaxConfig(),
                        causal: bool = True, window: int = 0,
                        block_q: int = 32, block_k: int = 256,
                        prune: bool = True, return_iters: bool = False,
                        page_table: Optional[torch.Tensor] = None, q_len=None):
    """The plain PyTorch version of `pim_attention`, on any device."""
    hkv = _check(q_q, q_scale, k_q, k_scale, v_q, v_scale, page_table)
    return _attention(q_q, q_scale, k_q, k_scale, v_q, v_scale, q_offset,
                      kv_len, lut_cfg, causal, window, block_q, block_k,
                      prune, return_iters, q_len, page_table, hkv, _plain)


def _attention(q_q, q_scale, k_q, k_scale, v_q, v_scale, q_offset, kv_len,
               lut_cfg, causal, window, block_q, block_k, prune,
               return_iters, q_len, page_table, hkv, impl):
    BH, Sq, Dh = q_q.shape
    paged = page_table is not None
    scalars = scalar_table(q_offset, kv_len, Sq if q_len is None else q_len,
                           q_q.device, page_table.shape[0] if paged else 1)
    nb = scalars.shape[1]
    if BH % nb or (paged and nb != page_table.shape[0]):
        raise ValueError(f"{BH} q rows do not split over {nb} sequences")
    if paged:
        block_k = k_q.shape[1]
    q_per_kv = BH // (nb * hkv) if paged else BH // k_q.shape[0]
    block_q = min(block_q, max(8, cdiv(Sq, 8) * 8))
    out, iters = impl(q_q, q_scale.float(), k_q, k_scale, v_q, v_scale,
                      page_table, scalars, q_per_kv, lut_cfg, causal, window,
                      block_q, block_k, prune)
    return (out, iters) if return_iters else out


def lut_online_step(m, codes, mask, table, frac: int):
    """One reference block's step of the online LUT softmax: from the
    running max `m` (..., rows) and the block's masked score codes
    (..., rows, block_k; _NEG where `mask` is False), the new running max,
    the rescale factor of the old sums (0 while m is unset) and the exps."""
    m_new = torch.maximum(m, codes.amax(dim=-1))
    resc = table[torch.clamp(m_new - m, 0, 255).long()] / float(1 << frac)
    resc = torch.where(m <= _NEG / 2, 0.0, resc)
    e = torch.where(
        mask, table[torch.clamp(m_new[..., None] - codes, 0, 255).long()],
        0.0)
    return m_new, resc, e


def _plain(q_q, q_scale, k_q, k_scale, v_q, v_scale, page_table, scalars,
           q_per_kv, lut_cfg, causal, window, bq, bk, prune):
    BH, Sq, Dh = q_q.shape
    dev = q_q.device
    # q row bh reads KV head `head` of sequence `seq`: the flat KV row of a
    # dense launch, the head inside a page row of a paged one
    seq = torch.arange(BH, device=dev) // (BH // scalars.shape[1])
    head = torch.arange(BH, device=dev) // q_per_kv
    if page_table is not None:
        head = head % k_q.shape[2]
    n_q = cdiv(Sq, bq)
    pq = n_q * bq - Sq
    f = torch.nn.functional
    q4 = f.pad(q_q, (0, 0, 0, pq)).reshape(BH, n_q, bq, Dh).double()
    qs4 = f.pad(q_scale, (0, pq)).reshape(BH, n_q, bq)
    # one KV row per q head (GQA groups read the same blocks)
    k_v, ks, v_v, vs, alloc = kv_blocks(k_q, k_scale, v_q, v_scale,
                                        page_table, seq, head, bk, Dh)
    n_k = k_v.shape[1]

    sc = scalars.long()[:, seq]                            # (3, BH)
    q_off, kvl, ql = sc[0, :, None], sc[1, :, None], sc[2, :, None]
    qi = torch.arange(n_q, device=dev)[None, :]
    q_lo = q_off + qi * bq                                 # (BH, n_q)
    q_hi = q_off + torch.minimum((qi + 1) * bq, ql) - 1
    q_pos = q_lo[..., None] + torch.arange(bq, device=dev)  # (BH, n_q, bq)
    table, frac = build_exp_table(lut_cfg, dev)
    table = table.float()
    sm_scale = 1.0 / (Dh ** 0.5)
    qmax = float((1 << (lut_cfg.input_bits - 1)) - 1)

    m = torch.full((BH, n_q, bq), _NEG, device=dev)
    den = torch.zeros((BH, n_q, bq), device=dev)
    acc = torch.zeros((BH, n_q, bq, Dh), device=dev)
    iters = torch.zeros((BH, n_q), dtype=torch.int32, device=dev)
    for ki in range(n_k):
        k_start = ki * bk
        needed = (qi * bq < ql) & alloc[:, ki:ki + 1]
        if prune:
            needed = needed & block_needed(k_start, bk, q_lo, q_hi, kvl,
                                           causal, window)
        if not bool(needed.any()):
            continue
        iters += needed.to(torch.int32)
        s_int = torch.einsum("bqid,bkd->bqik", q4, k_v[:, ki].double()).float()
        ksb = ks[:, ki]
        s_real = s_int * qs4[..., None] * ksb[:, None, None, :] * sm_scale
        codes = torch.clamp(torch.round(s_real / lut_cfg.score_scale),
                            -qmax - 1.0, qmax)
        k_pos = k_start + torch.arange(bk, device=dev)
        mask = k_pos < kvl[:, :, None, None]
        if causal:
            mask = mask & (k_pos <= q_pos[..., None])
        if window:
            mask = mask & (k_pos > q_pos[..., None] - window)
        codes = torch.where(mask, codes, _NEG)

        m_new, resc, e = lut_online_step(m, codes, mask, table, frac)
        vb = v_v[:, ki].float() * vs[:, ki][..., None]
        pv = torch.einsum("bqik,bkd->bqid", e, vb)
        upd = needed[..., None]
        den = torch.where(upd, den * resc + e.sum(dim=-1), den)
        acc = torch.where(upd[..., None], acc * resc[..., None] + pv, acc)
        m = torch.where(upd, m_new, m)
    out = acc / torch.clamp_min(den, 1.0)[..., None]
    return out.reshape(BH, n_q * bq, Dh)[:, :Sq], iters


def _lib():
    return _build.load("pim_attention", _SIGNATURES)


def check_launch_operands(ops, Dhk: int):
    """What both kernels need of their operands: 16-byte loads of whole
    K/V rows, from 16-byte aligned planes."""
    if Dhk % 16:
        raise ValueError(f"stored K/V head dim {Dhk} is not a multiple of 16")
    for t in ops:
        if t.data_ptr() % 16:
            raise ValueError("attention operands must be 16-byte aligned")


def _launch(q_q, q_scale, k_q, k_scale, v_q, v_scale, page_table, scalars,
            q_per_kv, lut_cfg, causal, window, bq, bk, prune):
    BH, Sq, Dh = q_q.shape
    Dhk = k_q.shape[-1]
    dev = q_q.device
    plan = launch_plan(Dh, Dhk, bq, q_per_kv, bk)
    lib = _lib()
    if lib.pim_attention_smem_bytes(plan.rows, Dh, bk) != plan.smem:
        raise RuntimeError("launch_plan's shared memory disagrees with the kernel's")
    ops = [t.contiguous() for t in
           (q_q, q_scale, k_q, k_scale.float(), v_q, v_scale.float())]
    check_launch_operands(ops, Dhk)
    pt = None if page_table is None else page_table.contiguous()
    table, frac = build_exp_table(lut_cfg, dev)
    levels = kv4_levels(dev)
    Sk = k_q.shape[1]
    n_q = cdiv(Sq, bq)
    n_k = cdiv(Sk, bk) if pt is None else pt.shape[1]
    out = torch.empty((BH, Sq, Dh), dtype=torch.float32, device=dev)
    iters = torch.empty((BH, n_q), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.pim_attention_launch(
        *[t.data_ptr() for t in ops], scalars.data_ptr(), scalars.shape[1],
        None if pt is None else pt.data_ptr(), table.data_ptr(),
        levels.data_ptr(), out.data_ptr(), iters.data_ptr(),
        BH, Sq, Dh, Dhk, Sk, bq, bk, n_q, n_k, q_per_kv,
        BH // scalars.shape[1], plan.rows, plan.heads_per_cta, int(causal),
        int(window), int(prune), 1.0 / (Dh ** 0.5), lut_cfg.score_scale,
        float((1 << (lut_cfg.input_bits - 1)) - 1), 1.0 / (1 << frac), stream)
    _build.check(err, "pim_attention launch")
    _build.LAUNCHES["pim_attention"] += 1
    if SHAPES is not None:
        SHAPES.append((scalars, tuple(q_q.shape), bool(causal)))
    return out, iters
