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

The kernel reads its operands in place: int8 or int32 scores, and a mask
through its own strides (`_operand`), so a mask broadcast over heads is
never copied.  `_plan` picks the kernel's regime by row length.
"""
from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Tuple

import torch

from repro_torch.configs.base import LUTSoftmaxConfig
from repro_torch.core.lut_softmax import build_exp_table
from repro_torch.core.quant import _div
from repro_torch.kernels import _build
from repro_torch.kernels.pim_matmul import _sm_count

_NEG = -(1 << 24)   # masked score code, below any real code
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {"lut_softmax_launch": [_P] * 6 + [_I] * 8 + [_F] * 2 + [_P]}

# the kernel's limits (csrc/lut_softmax.cu)
ROWS_MAX_S = 1024        # longest row one warp holds in registers (32 chunks of 32)
HELD_POSITIONS = 4       # positions a thread of a held row keeps in registers
MAX_DIMS = 4             # (size, stride) pairs of an operand's leading dims
SMEM_MAX = 232_448       # shared memory one CTA can use on the H100
_HEADER = 1024 + 32 * 8 + 32 * 4   # table, warp sums, warp maxima
_REGIMES = ("rows", "held", "staged", "stream")


class Plan(NamedTuple):
    """How the kernel covers `rows` rows of S positions: `regime`, `grid`
    CTAs of `threads` threads taking `rows_per_cta` rows each, `chunks`
    32-position chunks that a warp row's lane can hold (0 in the other
    regimes) and `smem` bytes of dynamic shared memory."""
    regime: str
    grid: int
    rows_per_cta: int
    threads: int
    chunks: int
    smem: int


def _pad16(n: int) -> int:
    return -(-n // 16) * 16


def _plan(rows: int, S: int, score_bytes: int, sms: int = 132) -> Plan:
    """The kernel's launch for (rows, S) scores of `score_bytes` bytes on a
    card of `sms` SMs.  Rows up to ROWS_MAX_S, when there are more than 8 of
    them an SM: a warp per row, 8 rows a CTA.  Other rows: a CTA per row, a
    thread per 4 positions (at least 2 warps, at most 32), the row held in
    registers up to 4 positions a thread, else staged in shared memory when
    it fits, else read from global memory in each step."""
    if S <= ROWS_MAX_S and rows > 8 * sms:
        chunks = 8 if S <= 256 else 16 if S <= 512 else 32
        return Plan("rows", -(-rows // 8), 8, 256, chunks, 1024)
    threads = 32 * min(32, max(2, -(-S // 128)))
    if S <= HELD_POSITIONS * threads:
        return Plan("held", rows, 1, threads, 0, _HEADER)
    staged = _HEADER + _pad16(S * score_bytes) + _pad16(S)
    if staged <= SMEM_MAX:
        return Plan("staged", rows, 1, threads, 0, staged)
    return Plan("stream", rows, 1, threads, 0, _HEADER)


def _row_map(t: torch.Tensor) -> List[Tuple[int, int]]:
    """(size, stride) pairs, outermost first, that map a row index of `t`'s
    leading dims to its element offset: dims of size 1 dropped, and a dim
    merged into the one outside it where their strides allow."""
    pairs: List[Tuple[int, int]] = []
    for size, stride in zip(t.shape[:-1], t.stride()[:-1]):
        if size == 1:
            continue
        if pairs and pairs[-1][1] == size * stride:
            pairs[-1] = (pairs[-1][0] * size, stride)
        else:
            pairs.append((size, stride))
    return pairs


def _operand(t: torch.Tensor) -> Tuple[torch.Tensor, List[Tuple[int, int]]]:
    """`t` as the kernel reads it, with its row map: as it is where its
    positions are at unit stride and its rows need at most MAX_DIMS pairs,
    else a contiguous copy."""
    if t.shape[-1] > 1 and t.stride(-1) != 1:
        t = t.contiguous()
    pairs = _row_map(t)
    if len(pairs) > MAX_DIMS:
        t = t.contiguous()
        pairs = _row_map(t)
    return t, pairs


def _check(scores_q: torch.Tensor, mask: torch.Tensor,
           cfg: LUTSoftmaxConfig) -> None:
    if cfg.mode != "shifted":
        raise ValueError("the LUT softmax kernel implements the shifted mode")
    if cfg.table_size != 256 or cfg.table_bits > 16:
        raise ValueError("the LUT softmax kernel takes a 256-entry table of "
                         f"at most 16 bits, not {cfg.table_size} x {cfg.table_bits}")
    if scores_q.dtype not in (torch.int8, torch.int32):
        raise ValueError(f"score codes are int8 or int32, not {scores_q.dtype}")
    if mask.dtype != torch.bool or mask.shape != scores_q.shape:
        raise ValueError("the mask is a bool tensor of the scores' shape, got "
                         f"{mask.dtype} {tuple(mask.shape)} for "
                         f"{tuple(scores_q.shape)}")
    if mask.device != scores_q.device:
        raise ValueError(f"scores on {scores_q.device}, mask on {mask.device}")
    if scores_q.dim() == 0 or scores_q.shape[-1] >= 2 ** 31 or \
            scores_q.numel() // max(scores_q.shape[-1], 1) >= 2 ** 31:
        raise ValueError("the LUT softmax kernel takes rows of fewer than 2^31 "
                         f"positions, fewer than 2^31 rows: {tuple(scores_q.shape)}")


def lut_softmax(scores_q: torch.Tensor, mask: torch.Tensor,
                cfg: LUTSoftmaxConfig = LUTSoftmaxConfig()) -> torch.Tensor:
    """(..., S) int8/int32 score codes and a bool mask of the same shape
    (any strides, a broadcast `expand` too) -> (..., S) int32
    Q0.<out_frac_bits> probability codes over the last axis (a row with no
    valid position gives all zeros)."""
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


def _map_arg(pairs: List[Tuple[int, int]]):
    """A row map as the kernel's {n, size[4], stride[4]} int64 array."""
    sizes = [s for s, _ in pairs] + [1] * (MAX_DIMS - len(pairs))
    strides = [st for _, st in pairs] + [0] * (MAX_DIMS - len(pairs))
    return (ctypes.c_longlong * (1 + 2 * MAX_DIMS))(len(pairs), *sizes, *strides)


def _launch(scores_q: torch.Tensor, mask: torch.Tensor,
            cfg: LUTSoftmaxConfig) -> torch.Tensor:
    dev = scores_q.device
    out = torch.empty(scores_q.shape, dtype=torch.int32, device=dev)
    if out.numel() == 0:
        return out
    S = scores_q.shape[-1]
    rows = out.numel() // S
    s, s_map = _operand(scores_q)
    mk, m_map = _operand(mask)
    plan = _plan(rows, S, s.element_size(), _sm_count(dev.index or 0))
    table, _ = build_exp_table(cfg, dev)
    err = _lib().lut_softmax_launch(
        s.data_ptr(), _map_arg(s_map), mk.data_ptr(), _map_arg(m_map),
        table.data_ptr(), out.data_ptr(), rows, S, s.element_size(),
        _REGIMES.index(plan.regime), plan.chunks, plan.grid, plan.threads, plan.smem,
        float(1 << cfg.out_frac_bits), float((1 << cfg.out_frac_bits) - 1),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "lut_softmax launch")
    _build.LAUNCHES["lut_softmax"] += 1
    return out
