"""Model assembly for attention stacks: parameter init, the serve cache and
the serve forward.

Counterpart of the JAX package's `models/transformer.py` on the classic
dense path.  Parameters keep the reference's tree: `"blocks"` is a tuple
with one stack per block-pattern position, each leaf carrying a leading
layer-repetition axis.  The reference scans over that axis; here it is a
Python loop over layer views.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import attention as A
from repro_torch.models import blocks as B
from repro_torch.models import layers as L


def check_supported(cfg: ModelConfig) -> None:
    """The port serves dense attention stacks; anything else raises."""
    unsupported = []
    if set(cfg.block_pattern) != {"attn"}:
        unsupported.append(f"block kinds {sorted(set(cfg.block_pattern))}")
    if cfg.moe.num_experts:
        unsupported.append("MoE")
    if cfg.window:
        unsupported.append("windowed (ring) caches")
    if cfg.is_encoder_decoder or cfg.num_image_patches:
        unsupported.append("encoder / image front ends")
    if cfg.pos not in ("rope", "none"):
        unsupported.append(f"pos={cfg.pos!r}")
    if unsupported:
        raise NotImplementedError(
            f"{cfg.name}: the port does not serve {', '.join(unsupported)} yet")


def pattern_layout(cfg: ModelConfig) -> Tuple[Tuple[str, ...], int, Tuple[str, ...]]:
    """(pattern, repetitions, tail_kinds): num_layers = R * len(pattern)
    (stacked) + len(tail) (unrolled remainder)."""
    pat = cfg.block_pattern
    n = cfg.num_layers
    if cfg.num_dense_layers and "moe" in pat:
        n -= cfg.num_dense_layers
    R = n // len(pat)
    rem = n - R * len(pat)
    tail = (pat * (rem // len(pat) + 1))[:rem]
    return pat, R, tail


def _attn_block_init(normal, zeros, ones, cfg: ModelConfig, lead):
    d, dh, f = cfg.d_model, cfg.resolved_head_dim, cfg.d_ff
    nq, nkv = cfg.num_heads, cfg.num_kv_heads

    def lin(d_in, d_out, bias=False):
        p = {"w": normal(lead + (d_in, d_out), 1.0 / d_in ** 0.5)}
        if bias:
            p["b"] = zeros(lead + (d_out,))
        return p

    mlp = {"w_in": lin(d, f), "w_out": lin(f, d)}
    if cfg.activation in ("swiglu", "geglu"):
        mlp = {"w_gate": lin(d, f), **mlp}
    return {
        "norm1": {"scale": ones(lead + (d,))},
        "attn": {"wq": lin(d, nq * dh, cfg.qkv_bias),
                 "wk": lin(d, nkv * dh, cfg.qkv_bias),
                 "wv": lin(d, nkv * dh, cfg.qkv_bias),
                 "wo": lin(nq * dh, d)},
        "norm2": {"scale": ones(lead + (d,))},
        "mlp": mlp,
    }


def init_params(generator: torch.Generator, cfg: ModelConfig,
                device) -> Dict[str, Any]:
    """Random fp parameters in the reference's tree, drawn on `device`
    from `generator` (which must live on that device)."""
    check_supported(cfg)
    pat, R, tail = pattern_layout(cfg)

    def normal(shape, scale):
        return torch.randn(shape, generator=generator, device=device) * scale

    def zeros(shape):
        return torch.zeros(shape, device=device)

    def ones(shape):
        return torch.ones(shape, device=device)

    params: Dict[str, Any] = {
        "embed": {"table": normal((cfg.vocab_size, cfg.d_model), 0.02)}}
    if not cfg.tie_embeddings:
        params["unembed"] = {
            "table": normal((cfg.vocab_size, cfg.d_model), 0.02)}
    params["blocks"] = tuple(_attn_block_init(normal, zeros, ones, cfg, (R,))
                             for _ in pat)
    params["tail"] = tuple(_attn_block_init(normal, zeros, ones, cfg, ())
                           for _ in tail)
    params["final_norm"] = {"scale": ones((cfg.d_model,))}
    return params


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device):
    """Serve state: one preallocated KV cache per layer, stacked like the
    parameters.  Forward steps update it in place."""
    pat, R, tail = pattern_layout(cfg)
    mk = dict(batch=batch, max_len=max_len, n_kv=cfg.num_kv_heads,
              head_dim=cfg.resolved_head_dim, kv_bits=cfg.kv_bits,
              device=device)
    return {"blocks": tuple(A.init_kv_cache(layers=R, **mk) for _ in pat),
            "tail": tuple(A.init_kv_cache(**mk) for _ in tail)}


def _index(tree, r: int):
    if isinstance(tree, dict):
        return {k: _index(v, r) for k, v in tree.items()}
    return tree[r]


def forward_serve(params, batch: Dict[str, torch.Tensor], cache, offset: int,
                  cfg: ModelConfig):
    """One serve step: prefill (offset 0, S prompt tokens) or decode (S == 1
    at offset = tokens already cached).  Writes the step's K/V into `cache`
    in place and returns (logits (B, V) at the last position, cache)."""
    pat, R, tail = pattern_layout(cfg)
    tokens = batch["tokens"]
    S = tokens.shape[1]
    x = L.embed_apply(params["embed"], tokens, getattr(torch, cfg.compute_dtype))
    for r in range(R):
        for j in range(len(pat)):
            x = B.attn_block_fwd_serve(_index(params["blocks"][j], r), x,
                                       cache["blocks"][j].layer(r), offset,
                                       cfg, causal=cfg.causal)
    for i in range(len(tail)):
        x = B.attn_block_fwd_serve(params["tail"][i], x, cache["tail"][i],
                                   offset, cfg, causal=cfg.causal)
    for c in cache["blocks"] + cache["tail"]:
        c.length = offset + S
    x = L.norm_apply(params["final_norm"], x[:, -1:], cfg.norm)
    head = params["embed"] if cfg.tie_embeddings else params["unembed"]
    return L.unembed_apply(head, x)[:, 0], cache
