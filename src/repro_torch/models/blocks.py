"""The serve-path attention block (`attn` kind).

Counterpart of the attention half of the JAX package's `models/blocks.py`
on the classic dense path: scalar offsets and a dense KV cache.  Serve-path
attention runs the paper's PIM pipeline, either the behavioral two-pass
(`cfg.attn_impl == "behavioral"`) or the fused kernels (`"kernel"`).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import attention as A
from repro_torch.core import pim
from repro_torch.kernels import ops
from repro_torch.models import layers as L


def _qkv(params, x: torch.Tensor, cfg: ModelConfig, pos_ids: torch.Tensor):
    B, S, _ = x.shape
    dh = cfg.resolved_head_dim
    p, en = cfg.pim, cfg.pim_linears
    q = pim.pim_linear_apply(params["wq"], x, p, en).reshape(B, S, cfg.num_heads, dh)
    k = pim.pim_linear_apply(params["wk"], x, p, en).reshape(B, S, cfg.num_kv_heads, dh)
    v = pim.pim_linear_apply(params["wv"], x, p, en).reshape(B, S, cfg.num_kv_heads, dh)
    if cfg.pos == "rope":
        q = L.rope_apply(q, pos_ids, cfg.rope_theta)
        k = L.rope_apply(k, pos_ids, cfg.rope_theta)
    return q, k, v


def _serve_attend(q, cache: A.KVCache, offset: int, cfg: ModelConfig,
                  window: int, causal: bool):
    out_dtype = getattr(torch, cfg.compute_dtype)
    if cfg.attn_impl == "kernel":
        # Sq == 1 steps go to the split-K decode kernel unless
        # cfg.decode_kernel opts out
        return ops.pim_flash_attention(
            q, cache, offset, cfg.pim, cfg.lut, causal=causal, window=window,
            out_dtype=out_dtype, decode_kernel=cfg.decode_kernel,
            decode_block_k=cfg.decode_block_k)
    if cfg.attn_impl != "behavioral":
        raise ValueError(f"unknown attn_impl {cfg.attn_impl!r}")
    return A.pim_attention(q, cache, cfg.pim, cfg.lut, q_offset=offset,
                           causal=causal, window=window, out_dtype=out_dtype)


def attn_block_fwd_serve(params, x: torch.Tensor, cache: A.KVCache,
                         offset: int, cfg: ModelConfig, window: int = 0,
                         causal: bool = True) -> torch.Tensor:
    """Prefill (S > 1, offset 0) or decode (S == 1, offset = cache fill).

    K/V of the step are quantized and written into `cache` in place before
    attention reads it."""
    B, S, _ = x.shape
    h = L.norm_apply(params["norm1"], x, cfg.norm)
    pos_ids = offset + torch.arange(S, device=x.device)
    q, k, v = _qkv(params["attn"], h, cfg, pos_ids)
    A.cache_write(cache, k, v, offset, cfg.pim)
    o = _serve_attend(q, cache, offset, cfg, window, causal)
    o = pim.pim_linear_apply(params["attn"]["wo"], o.reshape(B, S, -1),
                             cfg.pim, cfg.pim_linears)
    x = x + o
    h = L.norm_apply(params["norm2"], x, cfg.norm)
    return x + L.mlp_apply(params["mlp"], h, cfg)
