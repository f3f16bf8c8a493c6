"""Shared model layers: norms, embeddings, RoPE and the MLP (through PIM
linears).  Counterpart of the JAX package's `models/layers.py`; parameters
are plain dicts of tensors in the same tree layout."""
from __future__ import annotations

import functools
import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import pim


def pairwise_row_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last dim (keepdim) in a fixed order: the row is halved
    by elementwise adds until one column is left (an odd column joins
    column 0).  Elementwise ops round each element alone, so a row's sum
    never depends on the other rows of `x`."""
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        head = x[..., :h] + x[..., h:2 * h]
        x = head if x.shape[-1] % 2 == 0 else torch.cat(
            [head[..., :1] + x[..., 2 * h:], head[..., 1:]], dim=-1)
    return x


def row_mean(x: torch.Tensor) -> torch.Tensor:
    """Mean over the last dim (keepdim), whose bits do not depend on the
    other rows of `x`.  On the card torch's reduction splits a row
    differently with the number of rows, so a row normalized in a decode
    step (8 rows) and in a mixed step (thousands) could round differently
    and a served stream would depend on what it is batched with; there the
    row is summed by `pairwise_row_sum`.  The CPU keeps torch's mean, which
    equals the reference's eager one bit for bit."""
    if not x.is_cuda:
        return x.mean(dim=-1, keepdim=True)
    return pairwise_row_sum(x) / x.shape[-1]


def norm_apply(params, x: torch.Tensor, kind: str,
               eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    if kind == "layernorm":
        mu = row_mean(xf)
        var = row_mean((xf - mu) ** 2)
        y = (xf - mu) * torch.rsqrt(var + eps)
        y = y * params["scale"] + params["bias"]
    else:  # rmsnorm
        ms = row_mean(xf * xf)
        y = xf * torch.rsqrt(ms + eps) * params["scale"]
    return y.to(x.dtype)


def embed_apply(params, tokens: torch.Tensor, dtype) -> torch.Tensor:
    return params["table"][tokens].to(dtype)


UNEMBED_ROWS = 64


def unembed_apply(params, x: torch.Tensor) -> torch.Tensor:
    """Logits against the (V, D) head table, in the dtype of x.  On the
    card cuBLAS picks its kernel, and so a row's order of sums, by the
    number of rows (in float32 a row's logits change between 3 and 15
    rows), so a verify column's logits could differ from those of the
    single-token step it replaces; there the rows run through products of
    exactly UNEMBED_ROWS rows, the last one padded with zeros.  The CPU
    keeps one product."""
    w = params["table"].to(x.dtype).t()
    if not x.is_cuda:
        return x @ w
    rows = x.reshape(-1, x.shape[-1])
    n = rows.shape[0]
    rows = torch.nn.functional.pad(rows, (0, 0, 0, -n % UNEMBED_ROWS))
    out = torch.cat([rows[i:i + UNEMBED_ROWS] @ w
                     for i in range(0, rows.shape[0], UNEMBED_ROWS)])
    return out[:n].reshape(*x.shape[:-1], w.shape[1])


def rope_apply(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, S, H, Dh); positions: (S,) or (B, S)."""
    half = x.shape[-1] // 2
    freqs = torch.pow(theta, -torch.arange(half, dtype=torch.float32,
                                           device=x.device) / half)
    ang = positions.float()[..., None] * freqs
    ang = ang[None, :, None, :] if positions.dim() == 1 else ang[:, :, None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    y = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return y.to(x.dtype)


_SQRT_2_OVER_PI = math.sqrt(2.0 / math.pi)


@functools.lru_cache(maxsize=None)
def _rounded(v: float, dtype: torch.dtype) -> float:
    """The Python float `v` rounded to `dtype`."""
    return torch.tensor(v, dtype=dtype).item()


def gelu(x: torch.Tensor) -> torch.Tensor:
    """The reference's tanh-form GELU, x * 0.5 * (1 + tanh(sqrt(2 / pi) *
    (x + 0.044715 * x^3))), op by op with every constant first made a
    value of x's dtype, as the reference rounds its constants: in bfloat16
    bit for bit.  torch's fused `gelu(approximate="tanh")` rounds once at
    its end instead, and differs in about 43% of bf16 outputs.  In float32
    only tanh itself can differ from the reference's (an ulp).  The
    constants are host scalars (a scalar operand's product or sum is
    rounded to x's dtype like a tensor's), so no call copies to the card."""
    def c(v):
        return _rounded(v, x.dtype)

    inner = c(_SQRT_2_OVER_PI) * (x + c(0.044715) * x ** 3)
    return x * (c(0.5) * (c(1.0) + torch.tanh(inner)))


def _act(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind in ("silu", "swiglu"):
        # x * 1 / (1 + exp(-x)), each op rounded to x's dtype: the
        # reference's sigmoid, bit for bit in bfloat16
        return x * torch.reciprocal(1 + torch.exp(-x))
    if kind in ("gelu", "geglu"):
        return gelu(x)
    if kind == "relu_sq":
        return torch.square(torch.relu(x))
    raise ValueError(kind)


def mlp_apply(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    p, en = cfg.pim, cfg.pim_linears
    if "w_gate" in params:
        g = pim.pim_linear_apply(params["w_gate"], x, p, en)
        h = pim.pim_linear_apply(params["w_in"], x, p, en)
        h = _act(g, cfg.activation) * h
    else:
        h = _act(pim.pim_linear_apply(params["w_in"], x, p, en), cfg.activation)
    return pim.pim_linear_apply(params["w_out"], h, p, en)
