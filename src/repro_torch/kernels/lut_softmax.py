"""LUT softmax (shifted mode): the CUDA kernel's wrapper and its plain
PyTorch version.

Counterpart of the JAX package's `kernels/lut_softmax.py`
(`lut_softmax_pallas`).  The kernel is `csrc/lut_softmax.cu`; its header
says what it computes, what bounds it on the card and how.

`lut_softmax` launches the kernel for CUDA tensors and runs
`lut_softmax_plain` for CPU tensors, never one in place of the other.  Both
sum a row's exps as integers and round the sum once to float32, so they
agree bit for bit; the reference's float32 sum equals theirs while it stays
below 2^24.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.configs.base import LUTSoftmaxConfig
from repro_torch.core.lut_softmax import build_exp_table
from repro_torch.core.quant import _div
from repro_torch.kernels import _build

_NEG = -(1 << 24)   # masked score code, below any real code
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {"lut_softmax_launch": [_P] * 4 + [_I] * 2 + [_F] * 2 + [_P]}


def _check(scores_q: torch.Tensor, mask: torch.Tensor,
           cfg: LUTSoftmaxConfig) -> None:
    if cfg.mode != "shifted":
        raise ValueError("the LUT softmax kernel implements the shifted mode")
    if scores_q.dtype not in (torch.int8, torch.int32):
        raise ValueError(f"score codes are int8 or int32, not {scores_q.dtype}")
    if mask.dtype != torch.bool or mask.shape != scores_q.shape:
        raise ValueError("the mask is a bool tensor of the scores' shape, got "
                         f"{mask.dtype} {tuple(mask.shape)} for "
                         f"{tuple(scores_q.shape)}")
    if mask.device != scores_q.device:
        raise ValueError(f"scores on {scores_q.device}, mask on {mask.device}")


def lut_softmax(scores_q: torch.Tensor, mask: torch.Tensor,
                cfg: LUTSoftmaxConfig = LUTSoftmaxConfig()) -> torch.Tensor:
    """(..., S) int8/int32 score codes and a bool mask of the same shape ->
    (..., S) int32 Q0.<out_frac_bits> probability codes over the last axis
    (a row with no valid position gives all zeros)."""
    _check(scores_q, mask, cfg)
    if scores_q.is_cuda:
        return _launch(scores_q, mask, cfg)
    if scores_q.device.type != "cpu":
        raise ValueError(f"no lut_softmax kernel for {scores_q.device}")
    return lut_softmax_plain(scores_q, mask, cfg)


def lut_softmax_plain(scores_q: torch.Tensor, mask: torch.Tensor,
                      cfg: LUTSoftmaxConfig = LUTSoftmaxConfig()) -> torch.Tensor:
    """The plain PyTorch version of `lut_softmax`, on any device."""
    _check(scores_q, mask, cfg)
    table, _ = build_exp_table(cfg, scores_q.device)
    s = torch.where(mask, scores_q.to(torch.int32), _NEG)
    m = s.amax(dim=-1, keepdim=True)
    d = torch.clamp(m - s, 0, cfg.table_size - 1)
    e = torch.where(mask, table[d.long()], 0)
    denom = torch.clamp_min(e.sum(dim=-1, keepdim=True, dtype=torch.int64
                                  ).float(), 1.0)
    out_max = (1 << cfg.out_frac_bits) - 1
    codes = torch.floor(_div(e.float() * float(1 << cfg.out_frac_bits), denom))
    return torch.clamp(codes, 0, out_max).to(torch.int32)


def _lib():
    return _build.load("lut_softmax", _SIGNATURES)


def _launch(scores_q: torch.Tensor, mask: torch.Tensor,
            cfg: LUTSoftmaxConfig) -> torch.Tensor:
    S = scores_q.shape[-1]
    dev = scores_q.device
    s = scores_q.to(torch.int32).contiguous()
    mk = mask.contiguous()
    table, _ = build_exp_table(cfg, dev)
    out = torch.empty(s.shape, dtype=torch.int32, device=dev)
    rows = s.numel() // S if S else 0
    lib = _lib()
    err = lib.lut_softmax_launch(
        s.data_ptr(), mk.data_ptr(), table.data_ptr(), out.data_ptr(), rows,
        S, float(1 << cfg.out_frac_bits), float((1 << cfg.out_frac_bits) - 1),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "lut_softmax launch")
    _build.LAUNCHES["lut_softmax"] += 1
    return out
