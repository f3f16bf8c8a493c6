"""Fused flash-style PIM attention (prefill): the CUDA kernel's wrapper and
its plain PyTorch version.

Counterpart of the JAX package's `kernels/pim_attention.py`
(`pim_attention_pallas`).  The kernel is `csrc/pim_attention.cu`; its
header says what it computes, what bounds it on the card and how.

`pim_attention` launches the kernel for CUDA tensors and runs
`pim_attention_plain` for CPU tensors; it never falls back from one to the
other.  The plain version repeats the kernel's grid: the same q and KV
blocks, block early-outs, online update order and iteration counts, so it
is the kernel's reference on the card and the port's kernel path on the CPU.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.configs.base import LUTSoftmaxConfig, PIMConfig
from repro_torch.core.lut_softmax import build_exp_table
from repro_torch.core.quant import kv4_decode_int8, kv4_levels
from repro_torch.kernels import _build

_NEG = float(-(1 << 24))

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "pim_attention_launch": [_P] * 7 + [_I] + [_P] * 4 + [_I] * 14
                            + [_F] * 4 + [_P],
    "pim_attention_smem_bytes": [_I] * 3,
}
# the largest dynamic shared memory a block may have on the H100
MAX_SMEM = 227 * 1024


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def scalar_table(q_offset, kv_len, q_len, device):
    """The (3, nb) int32 table [q_offset, kv_len, q_len] of a launch; each
    entry is a scalar or a (B,) vector."""
    vals = (q_offset, kv_len, q_len)
    if all(isinstance(x, int) for x in vals):
        # one asynchronous copy from pinned memory, no stream synchronize
        host = torch.tensor([[x] for x in vals], dtype=torch.int32)
        if torch.device(device).type == "cuda":
            host = host.pin_memory()
        return host.to(device, non_blocking=True)
    cols = [torch.as_tensor(x, dtype=torch.int32, device=device).reshape(-1)
            for x in vals]
    nb = max(c.numel() for c in cols)
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


def _check(q_q, q_scale, k_q, k_scale, v_q, v_scale, page_table):
    if page_table is not None:
        raise NotImplementedError(
            "paged KV (page_table) waits for the port of the scheduler")
    BH, Sq, Dh = q_q.shape
    BHkv, Sk, Dhk = k_q.shape
    if Dhk not in (Dh, Dh // 2) or v_q.shape != k_q.shape:
        raise ValueError(f"K/V {tuple(k_q.shape)} do not fit q {tuple(q_q.shape)}")
    if BH % BHkv or q_scale.shape != (BH, Sq) or k_scale.shape != (BHkv, Sk) \
            or v_scale.shape != (BHkv, Sk):
        raise ValueError("attention operand shapes disagree")
    devs = {t.device for t in (q_q, q_scale, k_q, k_scale, v_q, v_scale)}
    if len(devs) != 1:
        raise ValueError(f"attention operands on several devices: {devs}")


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
    compare block for block."""
    _check(q_q, q_scale, k_q, k_scale, v_q, v_scale, page_table)
    if q_q.is_cuda:
        return _attention(q_q, q_scale, k_q, k_scale, v_q, v_scale, q_offset,
                          kv_len, lut_cfg, causal, window, block_q, block_k,
                          prune, return_iters, q_len, _launch)
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
    _check(q_q, q_scale, k_q, k_scale, v_q, v_scale, page_table)
    return _attention(q_q, q_scale, k_q, k_scale, v_q, v_scale, q_offset,
                      kv_len, lut_cfg, causal, window, block_q, block_k,
                      prune, return_iters, q_len, _plain)


def _attention(q_q, q_scale, k_q, k_scale, v_q, v_scale, q_offset, kv_len,
               lut_cfg, causal, window, block_q, block_k, prune,
               return_iters, q_len, impl):
    BH, Sq, Dh = q_q.shape
    scalars = scalar_table(q_offset, kv_len, Sq if q_len is None else q_len,
                           q_q.device)
    if BH % scalars.shape[1]:
        raise ValueError(f"{BH} q rows do not split over {scalars.shape[1]} "
                         "sequences")
    block_q = min(block_q, max(8, cdiv(Sq, 8) * 8))
    out, iters = impl(q_q, q_scale.float(), k_q, k_scale, v_q, v_scale,
                      scalars, lut_cfg, causal, window, block_q, block_k,
                      prune)
    return (out, iters) if return_iters else out


def _plain(q_q, q_scale, k_q, k_scale, v_q, v_scale, scalars, lut_cfg,
           causal, window, bq, bk, prune):
    BH, Sq, Dh = q_q.shape
    BHkv, Sk, _ = k_q.shape
    dev = q_q.device
    nb = scalars.shape[1]
    n_q, n_k = cdiv(Sq, bq), cdiv(Sk, bk)
    pq, pk = n_q * bq - Sq, n_k * bk - Sk
    f = torch.nn.functional
    q4 = f.pad(q_q, (0, 0, 0, pq)).reshape(BH, n_q, bq, Dh).double()
    qs4 = f.pad(q_scale, (0, pq)).reshape(BH, n_q, bq)
    k_v = f.pad(kv_values(k_q, Dh), (0, 0, 0, pk))
    v_v = f.pad(kv_values(v_q, Dh), (0, 0, 0, pk))
    ks, vs = f.pad(k_scale, (0, pk)), f.pad(v_scale, (0, pk))

    rows = torch.arange(BH, device=dev)
    seq = scalars.long()[:, rows // (BH // nb)]            # (3, BH)
    q_off, kvl, ql = seq[0, :, None], seq[1, :, None], seq[2, :, None]
    kv_rows = rows // (BH // BHkv)
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
        needed = qi * bq < ql
        if prune:
            needed = needed & block_needed(k_start, bk, q_lo, q_hi, kvl,
                                           causal, window)
        if not bool(needed.any()):
            continue
        iters += needed.to(torch.int32)
        kb = k_v[kv_rows, k_start:k_start + bk]           # (BH, bk, Dh)
        s_int = torch.einsum("bqid,bkd->bqik", q4, kb.double()).float()
        ksb = ks[kv_rows, k_start:k_start + bk]
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

        m_new = torch.maximum(m, codes.amax(dim=-1))
        resc = table[torch.clamp(m_new - m, 0, 255).long()] / float(1 << frac)
        resc = torch.where(m <= _NEG / 2, 0.0, resc)
        e = torch.where(
            mask, table[torch.clamp(m_new[..., None] - codes, 0, 255).long()],
            0.0)
        vb = v_v[kv_rows, k_start:k_start + bk].float() \
            * vs[kv_rows, k_start:k_start + bk][..., None]
        pv = torch.einsum("bqik,bkd->bqid", e, vb)
        upd = needed[..., None]
        den = torch.where(upd, den * resc + e.sum(dim=-1), den)
        acc = torch.where(upd[..., None], acc * resc[..., None] + pv, acc)
        m = torch.where(upd, m_new, m)
    out = acc / torch.clamp_min(den, 1.0)[..., None]
    return out.reshape(BH, n_q * bq, Dh)[:, :Sq], iters


def _lib():
    return _build.load("pim_attention", _SIGNATURES)


def _launch(q_q, q_scale, k_q, k_scale, v_q, v_scale, scalars, lut_cfg,
            causal, window, bq, bk, prune):
    BH, Sq, Dh = q_q.shape
    BHkv, Sk, Dhk = k_q.shape
    dev = q_q.device
    if Dh % 4 or Dhk % 4:
        raise ValueError(f"head dim {Dh} (stored {Dhk}) is not a multiple of 4")
    if bq * Dh > 32 * 256:
        raise ValueError(f"block_q * head_dim = {bq * Dh} exceeds 8192")
    lib = _lib()
    smem = lib.pim_attention_smem_bytes(bq, bk, Dh)
    if smem > MAX_SMEM:
        raise ValueError(f"block_q={bq}, block_k={bk}, Dh={Dh} need {smem} "
                         "bytes of shared memory")
    ops = [t.contiguous() for t in
           (q_q, q_scale, k_q, k_scale.float(), v_q, v_scale.float())]
    for t in ops:
        if t.data_ptr() % 16:
            raise ValueError("attention operands must be 16-byte aligned")
    table, frac = build_exp_table(lut_cfg, dev)
    levels = kv4_levels(dev)
    n_q, n_k = cdiv(Sq, bq), cdiv(Sk, bk)
    out = torch.empty((BH, Sq, Dh), dtype=torch.float32, device=dev)
    iters = torch.empty((BH, n_q), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.pim_attention_launch(
        *[t.data_ptr() for t in ops], scalars.data_ptr(), scalars.shape[1],
        table.data_ptr(), levels.data_ptr(), out.data_ptr(), iters.data_ptr(),
        BH, Sq, Dh, Dhk, Sk, bq, bk, n_q, n_k, BH // BHkv,
        BH // scalars.shape[1], int(causal), int(window), int(prune),
        1.0 / (Dh ** 0.5), lut_cfg.score_scale,
        float((1 << (lut_cfg.input_bits - 1)) - 1), 1.0 / (1 << frac), stream)
    _build.check(err, "pim_attention launch")
    _build.LAUNCHES["pim_attention"] += 1
    return out, iters
