"""The serve-path attention block (`attn` kind).

Counterpart of the attention half of the JAX package's `models/blocks.py`
on three storages: the classic dense cache (scalar offset), ragged dense
slots and the paged pool (per-row offsets).  Serve-path attention runs the
paper's PIM pipeline, either the behavioral two-pass
(`cfg.attn_impl == "behavioral"`) or the fused kernels (`"kernel"`).
Mixed prefill+decode steps and speculative verify rows are later slices.
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


def _serve_attend(q, cache: A.KVCache, offset, cfg: ModelConfig,
                  window: int, causal: bool, q_len=None):
    out_dtype = getattr(torch, cfg.compute_dtype)
    if cfg.attn_impl == "kernel":
        # Sq == 1 steps go to the split-K decode kernel unless
        # cfg.decode_kernel opts out
        return ops.pim_flash_attention(
            q, cache, offset, cfg.pim, cfg.lut, causal=causal, window=window,
            out_dtype=out_dtype, decode_kernel=cfg.decode_kernel,
            decode_block_k=cfg.decode_block_k, q_len=q_len)
    if cfg.attn_impl != "behavioral":
        raise ValueError(f"unknown attn_impl {cfg.attn_impl!r}")
    # per-row arithmetic: rows past a caller's q_len are garbage it ignores
    return A.pim_attention(q, cache, cfg.pim, cfg.lut, q_offset=offset,
                           causal=causal, window=window, out_dtype=out_dtype)


def _serve_attend_paged(q, pool: A.PagedKVCache, pages, kv_len, offset,
                        cfg: ModelConfig, causal: bool, q_len=None):
    """Attend over the paged pool: the kernel path walks the page table in
    both kernels; the behavioral path runs the two-pass pipeline over the
    gathered slot-dense view (the bit-exact paged reference)."""
    out_dtype = getattr(torch, cfg.compute_dtype)
    if cfg.attn_impl == "kernel":
        return ops.pim_paged_flash_attention(
            q, pool, pages, kv_len, offset, cfg.pim, cfg.lut, causal=causal,
            out_dtype=out_dtype, decode_kernel=cfg.decode_kernel, q_len=q_len)
    if cfg.attn_impl != "behavioral":
        raise ValueError(f"unknown attn_impl {cfg.attn_impl!r}")
    return A.pim_attention(q, A.paged_gather(pool, pages, kv_len), cfg.pim,
                           cfg.lut, q_offset=offset, causal=causal,
                           out_dtype=out_dtype)


def attn_block_fwd_serve(params, x: torch.Tensor, cache, offset,
                         cfg: ModelConfig, window: int = 0,
                         causal: bool = True, seq_lens=None, pages=None,
                         decode_rows=None, verify_len: int = 1
                         ) -> torch.Tensor:
    """Prefill (S > 1) or decode (S == 1) of one attention block.  K/V of
    the step are quantized and written into `cache` in place before
    attention reads it.

    Classic: `offset` is an int (0 for prefill, the cache fill for decode).
    Ragged slots: `offset` is a (B,) int32 device tensor of per-slot write
    positions and `seq_lens` the (B,) count of valid tokens of each row (0
    for an idle slot); each row masks against its own length.  Paged:
    `cache` is a `PagedKVCache` and `pages` the (B, max_pages) int32 page
    table; row b's valid length is offset_b + seq_lens_b (or + S).
    `decode_rows` (mixed steps) and `verify_len` > 1 (speculation) belong
    to later slices of the port and raise."""
    if decode_rows is not None or verify_len != 1:
        raise NotImplementedError(
            "mixed prefill+decode steps and speculative verify rows are not "
            "ported yet (ROADMAP.md §1 item 5 (d), (f))")
    B, S, _ = x.shape
    ragged = isinstance(offset, torch.Tensor)
    h = L.norm_apply(params["norm1"], x, cfg.norm)
    ar = torch.arange(S, device=x.device)
    pos_ids = offset[:, None] + ar[None, :] if ragged else offset + ar
    q, k, v = _qkv(params["attn"], h, cfg, pos_ids)
    if isinstance(cache, A.PagedKVCache):
        if pages is None or not ragged:
            raise ValueError("a paged serve step needs (B,) offsets and a "
                             "page table")
        if window:
            raise NotImplementedError("paged serving has no sliding window")
        A.paged_cache_write(cache, k, v, offset, cfg.pim, pages, seq_lens)
        kv_len = offset + (S if seq_lens is None else seq_lens)
        o = _serve_attend_paged(q, cache, pages, kv_len, offset, cfg, causal,
                                q_len=seq_lens)
    elif ragged:
        A.cache_write_ragged(cache, k, v, offset, cfg.pim, seq_lens)
        o = _serve_attend(q, cache, offset, cfg, window, causal,
                          q_len=seq_lens)
    else:
        A.cache_write(cache, k, v, offset, cfg.pim)
        o = _serve_attend(q, cache, offset, cfg, window, causal)
    o = pim.pim_linear_apply(params["attn"]["wo"], o.reshape(B, S, -1),
                             cfg.pim, cfg.pim_linears)
    x = x + o
    h = L.norm_apply(params["norm2"], x, cfg.norm)
    return x + L.mlp_apply(params["mlp"], h, cfg)
