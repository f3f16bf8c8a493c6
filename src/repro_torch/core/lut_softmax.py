"""Look-up-table softmax (AttentionLego §3.4).

Counterpart of the JAX package's `core/lut_softmax.py`: exp through a
256-entry fixed-point table, then a two-phase normalization (sum, divide).
The table is built with numpy and is bit-identical to the reference's.
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import LUTSoftmaxConfig


@functools.lru_cache(maxsize=None)
def _table_np(cfg: LUTSoftmaxConfig):
    n = cfg.table_size
    qmax = (1 << (cfg.input_bits - 1)) - 1
    out_max = (1 << cfg.table_bits) - 1
    if cfg.mode == "paper":
        frac = int(math.floor(math.log2(out_max / math.exp(qmax * cfg.score_scale))))
        frac = max(min(frac, cfg.table_frac_bits), 0)
        b = np.arange(-(n // 2), n // 2)
        vals = np.exp(b * cfg.score_scale) * (1 << frac)
    else:
        frac = cfg.table_frac_bits
        d = np.arange(n)
        vals = np.exp(-d * cfg.score_scale) * (1 << frac)
    table = np.clip(np.round(vals), 0, out_max).astype(np.int32)
    table.setflags(write=False)
    return table, frac


@functools.lru_cache(maxsize=None)
def build_exp_table(cfg: LUTSoftmaxConfig, device=None):
    """(table, frac_bits): int32 codes of the 16-bit exp entries, one copy
    per (config, device); callers never write it."""
    table, frac = _table_np(cfg)
    return torch.as_tensor(table.copy(), device=device), frac


def lut_exp(scores_q: torch.Tensor, cfg: LUTSoftmaxConfig,
            row_max: Optional[torch.Tensor] = None):
    """Exponent lookup of int8/int32 integer score codes."""
    table, frac = build_exp_table(cfg, scores_q.device)
    s = scores_q.to(torch.int32)
    if cfg.mode == "paper":
        idx = s + (cfg.table_size // 2)
    else:
        if row_max is None:
            row_max = s.amax(dim=-1, keepdim=True)
        idx = torch.clamp(row_max - s, 0, cfg.table_size - 1)
    return table[idx.long()], frac


def lut_softmax_codes(scores_q: torch.Tensor, cfg: LUTSoftmaxConfig,
                      mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Integer probability codes in Q0.<out_frac_bits> over the last axis."""
    if mask is not None and cfg.mode == "shifted":
        qmin = -(1 << (cfg.input_bits - 1))
        s = torch.where(mask, scores_q.to(torch.int32), qmin)
    else:
        s = scores_q.to(torch.int32)
    e, _ = lut_exp(s, cfg)
    if mask is not None:
        e = torch.where(mask, e, 0)
    # phase 1: sum of exponents (a wide digital accumulator, modeled in f32)
    ef = e.float()
    denom = torch.clamp_min(ef.sum(dim=-1, keepdim=True), 1.0)
    # phase 2: fixed-point divide -> Q0.<out_frac_bits>
    out_max = (1 << cfg.out_frac_bits) - 1
    codes = torch.clamp(
        torch.floor(ef * float(1 << cfg.out_frac_bits) / denom), 0, out_max)
    return codes.to(torch.int32)


def probs_to_uint8(codes: torch.Tensor, cfg: LUTSoftmaxConfig) -> torch.Tensor:
    """Requantize Q0.16 probability codes to uint8 inputs of the AV stage."""
    return (codes >> (cfg.out_frac_bits - 8)).to(torch.int32)
