"""Shared model layers: norms, embeddings, RoPE and the MLP (through PIM
linears).  Counterpart of the JAX package's `models/layers.py`; parameters
are plain dicts of tensors in the same tree layout."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import pim


def norm_apply(params, x: torch.Tensor, kind: str,
               eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    if kind == "layernorm":
        mu = xf.mean(dim=-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
        y = y * params["scale"] + params["bias"]
    else:  # rmsnorm
        ms = (xf * xf).mean(dim=-1, keepdim=True)
        y = xf * torch.rsqrt(ms + eps) * params["scale"]
    return y.to(x.dtype)


def embed_apply(params, tokens: torch.Tensor, dtype) -> torch.Tensor:
    return params["table"][tokens].to(dtype)


def unembed_apply(params, x: torch.Tensor) -> torch.Tensor:
    """Logits against the (V, D) head table, in the dtype of x."""
    return x @ params["table"].to(x.dtype).t()


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


def _act(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind in ("silu", "swiglu"):
        # x * 1 / (1 + exp(-x)), each op rounded to x's dtype: the
        # reference's sigmoid, bit for bit in bfloat16
        return x * torch.reciprocal(1 + torch.exp(-x))
    if kind in ("gelu", "geglu"):
        return torch.nn.functional.gelu(x, approximate="tanh")
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
