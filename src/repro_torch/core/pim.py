"""PIM macro behavioral model (AttentionLego §3.2) and the PIM linear layer.

Counterpart of the JAX package's `core/pim.py`.  int8 weights live in
128x128 crossbars; 16 word-lines are driven per analog step and each 16-row
partial sum may pass through a 6-bit ADC before digital accumulation.

Integer products stay exact: a dot over K = 8192 can exceed 2^24, so no
float32 product is used for them.  The ideal mode is the plain large
product the JAX package leaves to XLA: an int32 matmul on the CPU, cuBLAS's
int8 GEMM (`torch._int_mm`) on the GPU.  The quantized ADC mode goes through
`kernels/pim_matmul.py`: the CUDA kernel for CUDA tensors, its plain version
for CPU tensors.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import PIMConfig
from repro_torch.core import quant
from repro_torch.kernels.pim_matmul import pim_matmul_int as _adc_matmul


def _int_mm_cuda(x2: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 x (K, N) int8 -> (M, N) int32 through cuBLAS, which takes
    more than 16 rows and widths that are multiples of 8: rows are padded
    with zeros and cut off again."""
    M, K = x2.shape
    N = w_q.shape[1]
    if K % 8 or N % 8:
        raise ValueError(f"int8 GEMM needs K and N multiples of 8, got {K}, {N}")
    Mp = max(32, -(-M // 8) * 8)
    if Mp != M:
        x2 = torch.nn.functional.pad(x2, (0, 0, 0, Mp - M))
    return torch._int_mm(x2.contiguous(), w_q)[:M]


def pim_matmul_int(x_q: torch.Tensor, w_q: torch.Tensor,
                   cfg: PIMConfig) -> torch.Tensor:
    """Integer-domain macro-tiled matmul: (..., K) int8 x (K, N) int8 ->
    (..., N) float32 on the accumulation grid (int32-exact in ideal mode,
    ADC-grid values in quantized mode)."""
    K = x_q.shape[-1]
    assert w_q.shape[0] == K, (x_q.shape, w_q.shape)
    lead = x_q.shape[:-1]
    N = w_q.shape[-1]
    if cfg.adc_mode == "ideal":
        x2 = x_q.reshape(-1, K)
        if x_q.is_cuda:
            y = _int_mm_cuda(x2, w_q)
        else:
            y = x2.to(torch.int32) @ w_q.to(torch.int32)
        return y.float().reshape(lead + (N,))
    # every 16-row partial sum through the ADC: kernel 3 (or its plain
    # version on the CPU)
    return _adc_matmul(x_q.reshape(-1, K), w_q, cfg).reshape(lead + (N,))


def pim_matmul(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
               cfg: PIMConfig, x_scale: Optional[torch.Tensor] = None,
               out_dtype=torch.float32) -> torch.Tensor:
    """Full PIM forward: per-token input quantization, integer matmul and
    rescale, in the dtype promotions of the reference."""
    if x_scale is None:
        x_scale = quant.symmetric_max_scale(x, cfg.input_bits, axis=-1)
    x_q = quant.quantize(x, x_scale, cfg.input_bits)
    y = pim_matmul_int(x_q, w_q, cfg)
    return (y * x_scale.float() * w_scale.float()).to(out_dtype)


def quantize_weights(w: torch.Tensor, cfg: PIMConfig):
    """Per-output-channel symmetric weight quantization (the one-time load).
    `w` is (K, N) or a stacked (R, K, N); scales are (..., 1, N) in the dtype
    of `w`."""
    axis = -2 if cfg.per_channel else (-2, -1)
    scale = quant.symmetric_max_scale(w, cfg.weight_bits, axis=axis)
    return quant.quantize(w, scale, cfg.weight_bits), scale


def pim_linear_apply(params, x: torch.Tensor, cfg: PIMConfig,
                     enabled: bool = True) -> torch.Tensor:
    """Apply a linear layer through the PIM model.

    Takes deployed params {"w_q", "w_scale"} (weights quantized once at
    load) or fp params {"w"}, which are quantized from `w` cast to the
    activation dtype on every call, as the reference's QAT layer does."""
    if "w_q" in params:
        y = pim_matmul(x, params["w_q"], params["w_scale"], cfg,
                       out_dtype=x.dtype)
    elif enabled:
        w_q, w_scale = quantize_weights(params["w"].to(x.dtype), cfg)
        y = pim_matmul(x, w_q, w_scale, cfg, out_dtype=x.dtype)
    else:
        y = x @ params["w"].to(x.dtype)
    if "b" in params:
        y = y + params["b"].to(y.dtype)
    return y


def deploy_params(params, cfg: PIMConfig, dtype=None):
    """fp params -> deployed int8 macro contents.  `dtype` (default: the
    weight's own) is the dtype the weight is quantized in."""
    w = params["w"] if dtype is None else params["w"].to(dtype)
    w_q, w_scale = quantize_weights(w, cfg)
    out = {"w_q": w_q, "w_scale": w_scale}
    if "b" in params:
        out["b"] = params["b"]
    return out
