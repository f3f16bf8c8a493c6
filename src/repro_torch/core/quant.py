"""Quantization primitives of the PIM behavioral model.

Counterpart of the JAX package's `core/quant.py`.  Integer results are
bit-exact against it in float32 and in bfloat16: a bfloat16 division is
computed in float32 and rounded once to bfloat16, as XLA does, and every
division is by a tensor (a CUDA division by a Python scalar multiplies by
its reciprocal, which is not exact).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.configs.base import PIMConfig


def _div(x: torch.Tensor, y) -> torch.Tensor:
    """x / y in float32, rounded once to the promoted dtype of x and y (a
    Python number takes the dtype of x)."""
    if isinstance(y, torch.Tensor):
        dt = torch.promote_types(x.dtype, y.dtype)
    else:
        # a 0-dim tensor on the device: no host copy, and a true division
        y, dt = torch.full((), float(y), device=x.device), x.dtype
    return (x.float() / y.float()).to(dt)


def symmetric_max_scale(x: torch.Tensor, bits: int, axis=None,
                        eps: float = 1e-8) -> torch.Tensor:
    """Per-axis symmetric quantization scale so that max|x| -> qmax, in the
    dtype of `x` (keepdims when `axis` is given)."""
    qmax = (1 << (bits - 1)) - 1
    if axis is None:
        amax = x.abs().amax()
    else:
        amax = x.abs().amax(dim=axis, keepdim=True)
    return _div(torch.clamp_min(amax, eps), qmax)


def quantize(x: torch.Tensor, scale: torch.Tensor, bits: int,
             dtype=torch.int8) -> torch.Tensor:
    """Symmetric round-half-to-even quantization with saturation."""
    qmax = (1 << (bits - 1)) - 1
    return torch.clamp(torch.round(_div(x, scale)), -qmax - 1, qmax).to(dtype)


def adc_full_range(cfg: PIMConfig) -> float:
    """ADC full-scale: fraction of the theoretical max 16-row partial sum."""
    qmax_w = (1 << (cfg.weight_bits - 1)) - 1
    qmax_x = (1 << (cfg.input_bits - 1)) - 1
    return cfg.adc_range_frac * cfg.wordline_group * qmax_w * qmax_x


def _step(adc_bits: int, adc_range: float) -> float:
    return adc_range / (1 << (adc_bits - 1))


def adc_step(cfg: PIMConfig) -> float:
    """Reconstruction step of one ADC code."""
    return _step(cfg.adc_bits, adc_full_range(cfg))


def adc_code(psum: torch.Tensor, adc_bits: int,
             adc_range: float) -> torch.Tensor:
    """The paper's ADC: saturating uniform quantization of an integer partial
    sum to `adc_bits` levels over [-adc_range, adc_range); returns the
    integer codes as float32."""
    half = 1 << (adc_bits - 1)
    return torch.clamp(torch.round(_div(psum.float(), _step(adc_bits, adc_range))),
                       -half, half - 1)


def adc_transfer(psum: torch.Tensor, adc_bits: int,
                 adc_range: float) -> torch.Tensor:
    """The float32 reconstruction of `adc_code` on the ADC grid."""
    return adc_code(psum, adc_bits, adc_range) * _step(adc_bits, adc_range)


# ---------------------------------------------------------------------------
# Blockwise 4-bit KV codec (signed dynamic-map codebook)
# ---------------------------------------------------------------------------
def create_dynamic_map(signed: bool = True, max_exponent_bits: int = 2,
                       total_bits: int = 4) -> np.ndarray:
    """Signed dynamic data-type map (bitsandbytes `create_dynamic_map`):
    the sorted codebook in [-1, 1] with exactly 2**total_bits entries."""
    data = []
    non_sign_bits = total_bits - 1
    additional_items = 2 ** (non_sign_bits - max_exponent_bits) - 1
    for i in range(max_exponent_bits):
        fraction_items = int(
            2 ** (i + non_sign_bits - max_exponent_bits) + 1 if signed
            else 2 ** (i + non_sign_bits - max_exponent_bits + 1) + 1)
        boundaries = np.linspace(0.1, 1, fraction_items)
        means = (boundaries[:-1] + boundaries[1:]) / 2.0
        data += ((10 ** (-(max_exponent_bits - 1) + i)) * means).tolist()
        if signed:
            data += (-(10 ** (-(max_exponent_bits - 1) + i)) * means).tolist()
    if additional_items > 0:
        boundaries = np.linspace(0.1, 1, additional_items + 1)
        means = (boundaries[:-1] + boundaries[1:]) / 2.0
        data += means.tolist()
        if signed:
            data += (-means).tolist()
    data.append(0.0)
    if signed:
        data.append(1.0)
    assert len(data) == 2 ** total_bits, len(data)
    return np.sort(np.asarray(data, np.float64))


# The 16-entry map snapped to the int8 grid: dequantized 4-bit KV lands on
# exact int8 levels, so it reuses the absmax/127 scale planes unchanged and
# every integer dot over it stays exact.
KV4_LEVELS = np.rint(create_dynamic_map() * 127.0).astype(np.int8)
assert KV4_LEVELS.size == 16 and np.unique(KV4_LEVELS).size == 16
# nearest-level decision boundaries: code = searchsorted(midpoints, x/scale)
_KV4_MIDPOINTS = (KV4_LEVELS[:-1].astype(np.float32)
                  + KV4_LEVELS[1:].astype(np.float32)) / 2.0


@functools.lru_cache(maxsize=None)
def _kv4_midpoints(device) -> torch.Tensor:
    return torch.as_tensor(_KV4_MIDPOINTS, device=device)


def pack_codes4(codes: torch.Tensor) -> torch.Tensor:
    """Pack 4-bit codes two per byte along the last axis, half-split: byte j
    holds code j in its low nibble and code j + D/2 in its high nibble."""
    d = codes.shape[-1]
    assert d % 2 == 0, d
    lo = codes[..., : d // 2].to(torch.int32)
    hi = codes[..., d // 2:].to(torch.int32)
    packed = (lo & 0xF) | (hi << 4)
    # two's-complement wrap of the byte, as an int32 -> int8 cast does in XLA
    return (packed - ((packed & 0x80) << 1)).to(torch.int8)


def unpack_codes4(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of `pack_codes4`: (..., D/2) int8 -> (..., D) int32 codes."""
    p = packed.to(torch.int32) & 0xFF
    return torch.cat([p & 0xF, (p >> 4) & 0xF], dim=-1)


def kv4_encode(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Blockwise 4-bit encode: x/scale to the nearest dynamic-map level,
    packed two codes per int8 byte."""
    val = _div(x, scale)
    mids = _kv4_midpoints(x.device)
    # searchsorted(side="left") over the sorted midpoints == count(mid < v)
    codes = (val.float().unsqueeze(-1) > mids).sum(-1)
    return pack_codes4(codes)


@functools.lru_cache(maxsize=None)
def kv4_levels(device) -> torch.Tensor:
    """The (16,) int8 level table on `device` (one copy per device; never
    written)."""
    return torch.as_tensor(KV4_LEVELS, device=device)


def kv4_decode_int8(packed: torch.Tensor) -> torch.Tensor:
    """Packed 4-bit codes -> int8 values on the level grid (the per-block
    scale is not applied)."""
    return kv4_levels(packed.device)[unpack_codes4(packed).long()]
