"""Split-K flash decode for PIM attention: the CUDA kernel's wrapper, its
LUT-domain combine and the plain PyTorch version.

Counterpart of the JAX package's `kernels/pim_decode.py`
(`pim_decode_pallas`).  The kernels are `csrc/pim_decode.cu`; its header
says what they compute, what bounds them on the card and how.

`pim_decode` launches the kernels for CUDA tensors and runs the plain
version for CPU tensors, never one in place of the other.  The plain
version repeats the kernel's grid: the same row packing r = l * G + g, the
same page walk, per-partition early-outs and partials, and the same combine, which
runs the partitions in order with separately rounded multiply and add.
Rows are computed one at a time, so that a row's arithmetic never depends
on how many rows share the launch (verify rows stay bit-identical to
single-step decodes here too).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.configs.base import LUTSoftmaxConfig, PIMConfig
from repro_torch.core.lut_softmax import build_exp_table
from repro_torch.core.quant import kv4_levels
from repro_torch.kernels import _build
from repro_torch.kernels.pim_attention import (
    MAX_SMEM, _NEG, _check, block_needed, cdiv, check_launch_operands,
    kv_blocks, scalar_table)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "pim_decode_launch": [_P] * 7 + [_I] + [_P] * 7 + [_I] * 12 + [_F] * 3
                         + [_P],
    "pim_decode_combine_launch": [_P] * 5 + [_I] * 4 + [_F] + [_P],
    "pim_decode_smem_bytes": [_I] * 3,
}


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
    partition is one page (block_k is the page size, the grid is
    (n_tables, B * Hkv)), and an unallocated page emits (_NEG, 0, 0), an
    exact zero in the combine."""
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
    G = BH // BHkv
    R = Sq * G
    scalars = scalar_table(q_offset, kv_len, Sq if q_len is None else q_len,
                           q_q.device, page_table.shape[0] if paged else 1)
    nb = scalars.shape[1]
    if BHkv % nb or (paged and nb != page_table.shape[0]):
        raise ValueError(f"{BHkv} KV rows do not split over {nb} sequences")
    if paged:
        block_k = k_q.shape[1]
    # pack the q heads of each KV group and the verify positions as rows
    # r = l * G + g of one tile per KV head
    qg = q_q.reshape(BHkv, G, Sq, Dh).transpose(1, 2).reshape(BHkv, R, Dh)
    qsg = q_scale.float().reshape(BHkv, G, Sq).transpose(1, 2).reshape(BHkv, R)
    out, iters = impl(qg.contiguous(), qsg.contiguous(), k_q, k_scale, v_q,
                      v_scale, page_table, scalars, lut_cfg, G, Sq, causal,
                      window, block_k)
    out = out.reshape(BHkv, Sq, G, Dh).transpose(1, 2).reshape(BH, Sq, Dh)
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


def _plain(qg, qsg, k_q, k_scale, v_q, v_scale, page_table, scalars,
           lut_cfg, G, Sq, causal, window, bk):
    BHkv, R, Dh = qg.shape
    dev = qg.device
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
    k_start = torch.arange(n_k, device=dev) * bk
    needed = alloc & (ql[:, None] > 0) & block_needed(
        k_start[None, :], bk, q_pos[:, None], (q_pos + n_valid - 1)[:, None],
        kvl[:, None], causal, window)                      # (BHkv, n_k)
    k_pos = (k_start[:, None] + torch.arange(bk, device=dev))[None]
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
    return combine_plain(part_m, part_den, part_acc, lut_cfg), \
        needed.to(torch.int32)


def _lib():
    return _build.load("pim_decode", _SIGNATURES)


def _launch(qg, qsg, k_q, k_scale, v_q, v_scale, page_table, scalars,
            lut_cfg, G, Sq, causal, window, bk):
    BHkv, R, Dh = qg.shape
    Sk, Dhk = k_q.shape[1], k_q.shape[-1]
    dev = qg.device
    lib = _lib()
    smem = lib.pim_decode_smem_bytes(R, bk, Dh)
    if smem > MAX_SMEM:
        raise ValueError(f"{R} packed rows at block_k={bk}, Dh={Dh} need "
                         f"{smem} bytes of shared memory")
    ops = [qg, qsg] + [t.contiguous() for t in
                       (k_q, k_scale.float(), v_q, v_scale.float())]
    check_launch_operands(ops, Dhk)
    pt = None if page_table is None else page_table.contiguous()
    table, frac = build_exp_table(lut_cfg, dev)
    levels = kv4_levels(dev)
    n_k = cdiv(Sk, bk) if pt is None else pt.shape[1]
    part_m = torch.empty((BHkv, n_k, R), dtype=torch.float32, device=dev)
    part_den = torch.empty_like(part_m)
    part_acc = torch.empty((BHkv, n_k, R, Dh), dtype=torch.float32, device=dev)
    iters = torch.empty((BHkv, n_k), dtype=torch.int32, device=dev)
    out = torch.empty((BHkv, R, Dh), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.pim_decode_launch(
        *[t.data_ptr() for t in ops], scalars.data_ptr(), scalars.shape[1],
        None if pt is None else pt.data_ptr(), table.data_ptr(),
        levels.data_ptr(), part_m.data_ptr(), part_den.data_ptr(),
        part_acc.data_ptr(), iters.data_ptr(),
        BHkv, R, G, Sq, Dh, Dhk, Sk, bk, n_k, BHkv // scalars.shape[1],
        int(causal), int(window), 1.0 / (Dh ** 0.5), lut_cfg.score_scale,
        float((1 << (lut_cfg.input_bits - 1)) - 1), stream)
    _build.check(err, "pim_decode launch")
    err = lib.pim_decode_combine_launch(
        part_m.data_ptr(), part_den.data_ptr(), part_acc.data_ptr(),
        table.data_ptr(), out.data_ptr(), BHkv, n_k, R, Dh,
        1.0 / (1 << frac), stream)
    _build.check(err, "pim_decode combine launch")
    _build.LAUNCHES["pim_decode"] += 1
    return out, iters
