"""The serve-path attention block (`attn` kind, and `moe`: the same block
with a Mixture-of-Experts FFN in place of the MLP).

Counterpart of the attention half of the JAX package's `models/blocks.py`
on three storages: the classic dense cache (scalar offset), ragged dense
slots and the paged pool (per-row offsets).  Serve-path attention runs the
paper's PIM pipeline, either the behavioral two-pass
(`cfg.attn_impl == "behavioral"`) or the fused kernels (`"kernel"`), and
serves mixed prefill+decode steps and speculative verify rows.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import attention as A
from repro_torch.core import pim
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import moe as M


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


def _ffn(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The block's FFN: the MoE layer where the block carries "moe", else
    the MLP.  The reference also returns the MoE load-balance aux term,
    which only training reads; serving drops it."""
    if "moe" in params:
        return M.moe_ffn_apply(params["moe"], x, cfg)
    return L.mlp_apply(params["mlp"], x, cfg)


def _serve_attend(q, cache: A.KVCache, offset, cfg: ModelConfig,
                  window: int, causal: bool, q_len=None,
                  force_decode_kernel: bool = False):
    out_dtype = getattr(torch, cfg.compute_dtype)
    if cfg.attn_impl == "kernel":
        # Sq == 1 steps go to the split-K decode kernel unless
        # cfg.decode_kernel opts out
        return ops.pim_flash_attention(
            q, cache, offset, cfg.pim, cfg.lut, causal=causal, window=window,
            out_dtype=out_dtype, decode_kernel=cfg.decode_kernel,
            decode_block_k=cfg.decode_block_k, q_len=q_len,
            force_decode_kernel=force_decode_kernel)
    if cfg.attn_impl != "behavioral":
        raise ValueError(f"unknown attn_impl {cfg.attn_impl!r}")
    # per-row arithmetic: rows past a caller's q_len are garbage it ignores
    return A.pim_attention(q, cache, cfg.pim, cfg.lut, q_offset=offset,
                           causal=causal, window=window, out_dtype=out_dtype)


def _serve_attend_paged(q, pool: A.PagedKVCache, pages, kv_len, offset,
                        cfg: ModelConfig, causal: bool, q_len=None,
                        force_decode_kernel: bool = False):
    """Attend over the paged pool: the kernel path walks the page table in
    both kernels; the behavioral path runs the two-pass pipeline over the
    gathered slot-dense view (the bit-exact paged reference)."""
    out_dtype = getattr(torch, cfg.compute_dtype)
    if cfg.attn_impl == "kernel":
        return ops.pim_paged_flash_attention(
            q, pool, pages, kv_len, offset, cfg.pim, cfg.lut, causal=causal,
            out_dtype=out_dtype, decode_kernel=cfg.decode_kernel, q_len=q_len,
            force_decode_kernel=force_decode_kernel)
    if cfg.attn_impl != "behavioral":
        raise ValueError(f"unknown attn_impl {cfg.attn_impl!r}")
    return A.pim_attention(q, A.paged_gather(pool, pages, kv_len), cfg.pim,
                           cfg.lut, q_offset=offset, causal=causal,
                           out_dtype=out_dtype)


def _mixed_attend(q, cache, offset, kv_len, seq_lens, decode_rows,
                  cfg: ModelConfig, causal: bool, window: int = 0,
                  pages=None, verify_len: int = 1):
    """Mixed prefill+decode attention on the kernel path: two launches
    whose early-outs complement each other.  The prefill kernel serves the
    chunk rows (decode rows masked to q_len 0: no KV block); the decode
    dispatch serves the decode rows exactly as separate Sq == 1 steps
    would (the split-K kernel, or the prefill kernel when cfg.decode_kernel
    is off), on the step's first Lv = min(verify_len, S) query columns,
    with chunk rows masked to kv_len 0.  A decode row carries seq_lens in
    [1, verify_len] tokens, its current token and its speculative drafts,
    and each of its columns gets the bits of the single-token step it
    replaces; every row so gets the bits of its own unmixed dispatch.  The
    dense decode launch reads a copy of the cache record whose `length` is
    the decode rows' (the planes are shared, the record is not)."""
    seq_lens = seq_lens.int()
    Lv = min(int(verify_len), q.shape[1])
    ql_prefill = torch.where(decode_rows, 0, seq_lens)
    ql_decode = torch.where(decode_rows, torch.clamp(seq_lens, max=Lv), 0)
    kv_decode = torch.where(decode_rows, kv_len, 0).int()
    if pages is not None:
        o = _serve_attend_paged(q, cache, pages, kv_len, offset, cfg, causal,
                                q_len=ql_prefill)
        od = _serve_attend_paged(q[:, :Lv], cache, pages, kv_decode, offset,
                                 cfg, causal, q_len=ql_decode,
                                 force_decode_kernel=True)
    else:
        o = _serve_attend(q, cache, offset, cfg, window, causal,
                          q_len=ql_prefill)
        od = _serve_attend(q[:, :Lv], dataclasses.replace(cache,
                                                          length=kv_decode),
                           offset, cfg, window, causal, q_len=ql_decode,
                           force_decode_kernel=True)
    head = torch.where(decode_rows[:, None, None, None], od, o[:, :Lv])
    return torch.cat([head, o[:, Lv:]], dim=1)


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
    table; row b's valid length is offset_b + seq_lens_b (or + S).  A
    prefix-shared tail prefill is the paged case at offset > 0: the rows
    write only their tail and attend over [0, offset + seq_lens) through
    the table (the scheduler never lets a write land in a shared page).
    Mixed (ragged or paged): `decode_rows` is a (B,) bool of the rows
    carrying decode tokens; the kernel path routes the two classes
    through `_mixed_attend`, while the behavioral path's per-row
    arithmetic needs no routing.  `verify_len` > 1 (speculation) widens a
    decode row to up to verify_len tokens, its current token and drafts,
    all verified through the split-K decode launch in one step."""
    mixed = decode_rows is not None and cfg.attn_impl == "kernel"
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
        if mixed:
            o = _mixed_attend(q, cache, offset, kv_len, seq_lens, decode_rows,
                              cfg, causal, pages=pages, verify_len=verify_len)
        else:
            o = _serve_attend_paged(q, cache, pages, kv_len, offset, cfg,
                                    causal, q_len=seq_lens)
    elif ragged:
        A.cache_write_ragged(cache, k, v, offset, cfg.pim, seq_lens)
        if mixed:
            o = _mixed_attend(q, cache, offset, cache.length, seq_lens,
                              decode_rows, cfg, causal, window=window,
                              verify_len=verify_len)
        else:
            o = _serve_attend(q, cache, offset, cfg, window, causal,
                              q_len=seq_lens)
    else:
        A.cache_write(cache, k, v, offset, cfg.pim)
        o = _serve_attend(q, cache, offset, cfg, window, causal)
    o = pim.pim_linear_apply(params["attn"]["wo"], o.reshape(B, S, -1),
                             cfg.pim, cfg.pim_linears)
    x = x + o
    h = L.norm_apply(params["norm2"], x, cfg.norm)
    return x + _ffn(params, h, cfg)
