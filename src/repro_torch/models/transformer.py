"""Model assembly for attention stacks: parameter init, the serve cache and
the serve forward.

Counterpart of the JAX package's `models/transformer.py` for serving
attention stacks: the classic dense cache, ragged slots and the paged pool.
Parameters keep the reference's tree: `"blocks"` is a tuple with one stack
per block-pattern position, each leaf carrying a leading layer-repetition
axis.  The reference scans over that axis; here it is a Python loop over
layer views.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import attention as A
from repro_torch.models import blocks
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


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device,
               ragged: bool = False, page_size: int = 0, num_pages: int = 0):
    """Serve state: one preallocated KV cache per layer, stacked like the
    parameters; forward steps update it in place.  `ragged` gives every
    cache (B,) per-slot lengths (all 0: every slot empty), the layout the
    continuous-batching scheduler needs.  With `page_size` every layer
    holds instead a `PagedKVCache` pool of `num_pages` pages (page 0 is the
    trash page); slots are rows of the page table that the caller passes
    to `forward_serve(pages=...)`, the same row naming the same pages in
    every layer."""
    pat, R, tail = pattern_layout(cfg)
    if page_size:
        mk = dict(num_pages=num_pages, page_size=page_size,
                  n_kv=cfg.num_kv_heads, head_dim=cfg.resolved_head_dim,
                  kv_bits=cfg.kv_bits, device=device)
        return {"blocks": tuple(A.init_paged_kv_cache(layers=R, **mk)
                                for _ in pat),
                "tail": tuple(A.init_paged_kv_cache(**mk) for _ in tail)}
    mk = dict(batch=batch, max_len=max_len, n_kv=cfg.num_kv_heads,
              head_dim=cfg.resolved_head_dim, kv_bits=cfg.kv_bits,
              device=device, ragged=ragged)
    return {"blocks": tuple(A.init_kv_cache(layers=R, **mk) for _ in pat),
            "tail": tuple(A.init_kv_cache(**mk) for _ in tail)}


def cache_scatter(big, sub, slots: torch.Tensor):
    """Copy the batch rows of a sub-batch ragged cache into slots of a big
    one, in place: big[..., slots[i], :, :L] = sub[..., i] for every plane,
    where L, the sub-batch cache's max_len, is at most the big one's; the
    per-slot lengths follow.  A slot's bytes up to its length are then those
    of the reference's whole-row scatter (what lies past it is never read).
    `slots` is an (n,) int64 device tensor."""
    for b, s in zip(big["blocks"] + big["tail"], sub["blocks"] + sub["tail"]):
        ax = b.k_q.dim() - 4                  # 1 with the stacked layer axis
        L = s.k_q.shape[ax + 2]
        for f in ("k_q", "v_q", "k_scale", "v_scale"):
            getattr(b, f).narrow(ax + 2, 0, L).index_copy_(ax, slots,
                                                           getattr(s, f))
        b.length.index_copy_(0, slots, s.length)
    return big


def cache_copy_pages(cache, src, dst):
    """Copy pages `src[i]` -> `dst[i]` in every layer's paged pool, in
    place: a slot's table row names the same page ids in every layer, so
    one copy-on-write decision applies to the whole stack.  Pools under
    "blocks" carry the layer axis (page axis 1), "tail" pools do not."""
    for key, axis in (("blocks", 1), ("tail", 0)):
        for pool in cache[key]:
            A.copy_pages(pool, src, dst, page_axis=axis)
    return cache


def cache_fetch_pages(cache, pages):
    """Gather pages `pages[i]` out of every layer's paged pool: a tree of
    the cache's structure whose pools are replaced by the gathered pages
    (page axis 1 under "blocks", 0 under "tail") and whose other leaves
    are None.  One fetch covers the stack, since a slot's table row names
    the same pages in every layer."""
    def visit(node, axis):
        if isinstance(node, A.PagedKVCache):
            return A.fetch_pages(node, pages, page_axis=axis)
        if isinstance(node, (tuple, list)):
            return type(node)(visit(v, axis) for v in node)
        return None

    return {k: visit(v, 1 if k == "blocks" else 0) for k, v in cache.items()}


def cache_page_checksums(cache, pages):
    """Per-page crc32 over every layer's paged pool, chained in the
    reference's visit order (dict keys sorted, tuples in order; a stacked
    pool's page covers all its layers at once), so page i's crc covers the
    whole stack's bytes of that page.  Takes the live cache (page ids) or
    a `cache_fetch_pages` host tree (positions; its None leaves are
    skipped).  Returns uint32[len(pages)]."""
    crcs = np.zeros(len(pages), dtype=np.uint32)

    def visit(node, axis):
        nonlocal crcs
        if isinstance(node, A.PagedKVCache):
            crcs = A.page_checksums(node, pages, page_axis=axis, seeds=crcs)
        elif isinstance(node, dict):
            for k in sorted(node):
                visit(node[k], axis)
        elif isinstance(node, (tuple, list)):
            for v in node:
                visit(v, axis)

    for k in sorted(cache):
        visit(cache[k], 1 if k == "blocks" else 0)
    return crcs


def cache_restore_pages(cache, pages, data):
    """Scatter a `cache_fetch_pages` tree back into every layer's pool, in
    place: pool page `pages[i]` := `data` page i (None leaves of `data`
    leave the cache leaf as it is)."""
    def visit(node, d, axis):
        if isinstance(node, A.PagedKVCache) and d is not None:
            A.restore_pages(node, pages, d, page_axis=axis)
        elif isinstance(node, (tuple, list)):
            for v, dv in zip(node, d):
                visit(v, dv, axis)

    for k, v in cache.items():
        visit(v, data[k], 1 if k == "blocks" else 0)
    return cache


def _index(tree, r: int):
    if isinstance(tree, dict):
        return {k: _index(v, r) for k, v in tree.items()}
    return tree[r]


def forward_serve(params, batch: Dict[str, torch.Tensor], cache, offset,
                  cfg: ModelConfig, seq_lens=None, pages=None,
                  decode_rows=None, logit_positions=None, verify_len: int = 1):
    """One serve step: a prefill chunk, a single-token decode or a mixed
    batch of both.  Writes the step's K/V into `cache` in place and returns
    (logits (B, V), cache).

    Classic: `offset` is an int and logits come from the last position.
    Ragged slots (`offset` a (B,) int32 tensor on the tokens' device): row
    b writes at offset_b and `seq_lens` counts its valid tokens (padding
    past it is written but never advertised); logits come from each row's
    last valid position (a row with seq_lens 0 reads position 0: garbage
    the caller masks).  Paged: `cache` holds `PagedKVCache` pools and
    `pages` is the (B, max_pages) page table every layer writes and attends
    through.  Mixed: `decode_rows` is a (B,) bool marking the rows that
    carry one decode token (the rest carry prefill chunks, or nothing);
    on the kernel path every layer sends each class through the kernel its
    separate dispatch would use (`blocks._mixed_attend`).  Speculative
    verify: `verify_len` widens a decode row to up to that many tokens
    (current token and drafts), and `logit_positions`, a (B, P) int tensor
    of in-step columns, asks for logits at every one of them: the return
    is then (B, P, V), column j of a row equal to the logits of the
    single-token step it replaces.  Every layer reuses the step's offsets,
    lengths and table as they are: callers bring them to the device once
    per step."""
    pat, R, tail = pattern_layout(cfg)
    tokens = batch["tokens"]
    B, S = tokens.shape
    ragged = isinstance(offset, torch.Tensor)
    x = L.embed_apply(params["embed"], tokens, getattr(torch, cfg.compute_dtype))
    kw = dict(causal=cfg.causal, seq_lens=seq_lens, pages=pages,
              decode_rows=decode_rows, verify_len=verify_len)
    for r in range(R):
        for j in range(len(pat)):
            x = blocks.attn_block_fwd_serve(
                _index(params["blocks"][j], r), x,
                cache["blocks"][j].layer(r), offset, cfg, **kw)
    for i in range(len(tail)):
        x = blocks.attn_block_fwd_serve(params["tail"][i], x,
                                        cache["tail"][i], offset, cfg, **kw)
    if pages is None:
        for c in cache["blocks"] + cache["tail"]:
            max_len = c.k_q.shape[-2]
            c.length = offset + S if not ragged else torch.clamp(
                offset + (S if seq_lens is None else seq_lens), max=max_len
            ).to(torch.int32)
    if logit_positions is not None:
        idx = torch.clamp(logit_positions.long(), 0, S - 1)
    elif seq_lens is not None:
        idx = (torch.clamp(seq_lens.long(), min=1) - 1)[:, None]
    else:
        idx = None
    if idx is None:
        x = x[:, -1:]
    else:
        x = torch.gather(x, 1, idx[:, :, None].expand(*idx.shape, x.shape[-1]))
    x = L.norm_apply(params["final_norm"], x, cfg.norm)
    head = params["embed"] if cfg.tie_embeddings else params["unembed"]
    logits = L.unembed_apply(head, x)
    return (logits if logit_positions is not None else logits[:, 0]), cache
