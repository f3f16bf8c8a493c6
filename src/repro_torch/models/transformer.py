"""Model assembly for attention, MoE and hybrid RG-LRU stacks: parameter
init, the serve state and the serve forward (with a VLM's image patch
embeddings projected into the first positions of a prompt).

Counterpart of the JAX package's `models/transformer.py` for serving:
attention and MoE stacks on the classic dense cache, ragged slots and the
paged pool; sliding-window attention (`attn_local`, ring caches past the
window) and RG-LRU blocks on the classic path.  Parameters keep the
reference's tree: `"blocks"` is a tuple with one stack per block-pattern
position, each leaf carrying a leading layer-repetition axis; `"tail"`
holds the unrolled remainder and, for a MoE arch with dense leading layers
(deepseek-moe), `"dense_prefix"` those layers, which run first.  The
reference scans over the layer axis; here it is a Python loop over layer
views.  Serve-state trees carry the same keys; leaves under "blocks" have
the layer axis first (batch or page axis 1), those under "tail" and
"dense_prefix" do not (axis 0).
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import attention as A
from repro_torch.core import pim
from repro_torch.models import blocks
from repro_torch.models import layers as L
from repro_torch.models import moe as M


SERVED_KINDS = ("attn", "attn_local", "moe", "rglru")


def check_supported(cfg: ModelConfig) -> None:
    """The port serves attention, sliding-window attention, MoE and RG-LRU
    stacks, with image patch embeddings (the VLM stub); anything else
    raises, naming the ROADMAP item (§1) that ports it."""
    unsupported = []
    kinds = set(cfg.block_pattern) - set(SERVED_KINDS)
    if kinds:
        unsupported.append(f"block kinds {sorted(kinds)} (item 7: xlstm-1.3b's "
                           "mlstm / slstm, whisper-tiny's xattn / enc_attn)")
    if "moe" in cfg.block_pattern and not cfg.moe.num_experts:
        unsupported.append("a moe block without experts")
    if cfg.is_encoder_decoder:
        unsupported.append("an encoder (item 7: whisper-tiny)")
    if cfg.pos not in ("rope", "none"):
        unsupported.append(f"pos={cfg.pos!r} (item 7: whisper-tiny)")
    if unsupported:
        raise NotImplementedError(
            f"{cfg.name}: the port does not serve {', '.join(unsupported)} yet")


def pattern_layout(cfg: ModelConfig) -> Tuple[Tuple[str, ...], int, Tuple[str, ...]]:
    """(pattern, repetitions, tail_kinds): num_layers = num_dense_layers
    (a MoE arch's dense prefix) + R * len(pattern) (stacked) + len(tail)
    (unrolled remainder)."""
    pat = cfg.block_pattern
    n = cfg.num_layers
    if cfg.num_dense_layers and "moe" in pat:
        n -= cfg.num_dense_layers
    R = n // len(pat)
    rem = n - R * len(pat)
    tail = (pat * (rem // len(pat) + 1))[:rem]
    return pat, R, tail


def _moe_kind_for_layer(cfg: ModelConfig, kind: str, layer_idx: int) -> str:
    """deepseek-moe keeps the first `num_dense_layers` layers dense."""
    if kind == "moe" and layer_idx < cfg.num_dense_layers:
        return "attn"
    return kind


def _block_init(kind: str, normal, ones, linear, expert_linear,
                cfg: ModelConfig, lead):
    """One block, or a stack of them (`lead` the layer axis).  An attention
    block (`attn`, `attn_local`) carries an MLP, a `moe` one a MoE FFN in
    its place; the FFN is drawn before the attention, as every earlier
    slice drew it (the weights of a seed stay those of earlier runs)."""
    d, dh, f = cfg.d_model, cfg.resolved_head_dim, cfg.d_ff
    nq, nkv = cfg.num_heads, cfg.num_kv_heads

    def lin(d_in, d_out, bias=False):
        return linear(lead, d_in, d_out, 1.0 / d_in ** 0.5, bias)

    def mlp():
        m = {"w_in": lin(d, f), "w_out": lin(f, d)}
        if cfg.activation in ("swiglu", "geglu"):
            m = {"w_gate": lin(d, f), **m}
        return m

    if kind == "rglru":
        return _rglru_init(normal, ones, lin, mlp, cfg, lead)
    if kind == "moe":
        ffn = {"moe": M.moe_ffn_init(normal, cfg, lead, expert_linear)}
    else:
        ffn = {"mlp": mlp()}
    return {
        "norm1": {"scale": ones(lead + (d,))},
        "attn": {"wq": lin(d, nq * dh, cfg.qkv_bias),
                 "wk": lin(d, nkv * dh, cfg.qkv_bias),
                 "wv": lin(d, nkv * dh, cfg.qkv_bias),
                 "wo": lin(nq * dh, d)},
        "norm2": {"scale": ones(lead + (d,))},
        **ffn,
    }


def _rglru_init(normal, ones, lin, mlp, cfg: ModelConfig, lead):
    """An RG-LRU block in the reference's tree: PIM linears w_x, w_gate,
    w_out; raw float32 conv_w (W, w), conv_b, the gates' (w, w) matrices
    and lambda_p (sigmoid(4) ~ 0.982)."""
    d, w = cfg.d_model, cfg.lru_width or cfg.d_model
    p = {"norm": {"scale": ones(lead + (d,))},
         "w_x": lin(d, w), "w_gate": lin(d, w),
         "conv_w": normal(lead + (cfg.conv1d_width, w), 0.1),
         "conv_b": ones(lead + (w,)).zero_(),
         "w_input_gate": normal(lead + (w, w), 1.0 / w ** 0.5),
         "w_rec_gate": normal(lead + (w, w), 1.0 / w ** 0.5),
         "lambda_p": ones(lead + (w,)) * 4.0,
         "w_out": lin(w, d)}
    return {**p, "norm2": {"scale": ones(lead + (d,))}, "mlp": mlp()}


def init_params(generator: torch.Generator, cfg: ModelConfig,
                device, expert_linear=None, deploy=None) -> Dict[str, Any]:
    """Random parameters in the reference's tree, drawn on `device` from
    `generator` (which must live on that device).  Every linear is an fp
    {"w"} drawn whole, N(0, scale^2), with zero biases, and passed through
    `deploy` when it is given, but a stack of experts (a `lead` of layer
    and expert axes), which `expert_linear(lead, d_in, d_out, scale)`
    makes when it is given.  A config with image patches also gets
    `img_proj`, a (d_model, d_model) linear without bias, drawn after the
    head table, so every other config's draws stay as they were."""
    check_supported(cfg)
    pat, R, tail = pattern_layout(cfg)

    def normal(shape, scale):
        return torch.randn(shape, generator=generator, device=device) * scale

    def ones(shape):
        return torch.ones(shape, device=device)

    def fp_linear(lead, d_in, d_out, scale, bias=False):
        p = {"w": normal(lead + (d_in, d_out), scale)}
        if bias:
            p["b"] = torch.zeros(lead + (d_out,), device=device)
        return p

    def linear(lead, d_in, d_out, scale, bias=False):
        p = fp_linear(lead, d_in, d_out, scale, bias)
        return p if deploy is None else deploy(p)

    blk = functools.partial(_block_init, normal=normal, ones=ones,
                            linear=linear,
                            expert_linear=expert_linear or linear, cfg=cfg)
    params: Dict[str, Any] = {
        "embed": {"table": normal((cfg.vocab_size, cfg.d_model), 0.02)}}
    if not cfg.tie_embeddings:
        params["unembed"] = {
            "table": normal((cfg.vocab_size, cfg.d_model), 0.02)}
    if cfg.num_image_patches:
        params["img_proj"] = linear((), cfg.d_model, cfg.d_model,
                                    1.0 / cfg.d_model ** 0.5)
    params["blocks"] = tuple(blk(kind, lead=(R,)) for kind in pat)
    params["tail"] = tuple(
        blk(_moe_kind_for_layer(cfg, kind, R * len(pat) + i), lead=())
        for i, kind in enumerate(tail))
    if cfg.num_dense_layers and "moe" in pat:
        params["dense_prefix"] = tuple(
            blk("attn", lead=()) for _ in range(cfg.num_dense_layers))
    params["final_norm"] = {"scale": ones((cfg.d_model,))}
    return params


def _state_init(kind: str, cfg: ModelConfig, batch: int, max_len: int,
                device, layers=None, ragged: bool = False,
                page_size: int = 0, num_pages: int = 0):
    """One layer's serve state, or a stack of them (`layers`): a KV cache
    (dense, ragged or a paged pool) for an attention kind, {"h", "conv"}
    for an RG-LRU block.  A sliding-window layer whose context outgrows
    its window (max_len > window) gets a ring of `window` slots, always
    int8, as the reference's."""
    dh = cfg.resolved_head_dim
    if page_size:
        if kind not in ("attn", "moe"):
            raise NotImplementedError(
                f"paged KV serves attention stacks only (got {kind!r})")
        return A.init_paged_kv_cache(num_pages, page_size, cfg.num_kv_heads,
                                     dh, kv_bits=cfg.kv_bits, device=device,
                                     layers=layers)
    lead = () if layers is None else (layers,)
    if kind == "rglru":
        w = cfg.lru_width or cfg.d_model
        z = dict(dtype=torch.float32, device=device)
        return {"h": torch.zeros(lead + (batch, w), **z),
                "conv": torch.zeros(lead + (batch, cfg.conv1d_width - 1, w), **z)}
    ring = kind == "attn_local" and bool(cfg.window) and max_len > cfg.window
    return A.init_kv_cache(batch, min(max_len, cfg.window) if ring else max_len,
                           cfg.num_kv_heads, dh,
                           kv_bits=8 if ring else cfg.kv_bits, device=device,
                           layers=layers, ragged=ragged, ring=ring)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device,
               ragged: bool = False, page_size: int = 0, num_pages: int = 0):
    """Serve state: one preallocated state per layer, stacked like the
    parameters; forward steps update it in place.  An attention layer
    holds a KV cache (a ring for a sliding-window layer past its window),
    an RG-LRU layer its recurrent and conv state.  `ragged` gives every
    cache (B,) per-slot lengths (all 0: every slot empty), the layout the
    continuous-batching scheduler needs.  With `page_size` every layer
    holds instead a `PagedKVCache` pool of `num_pages` pages (page 0 is the
    trash page); slots are rows of the page table that the caller passes
    to `forward_serve(pages=...)`, the same row naming the same pages in
    every layer."""
    pat, R, tail = pattern_layout(cfg)
    one = functools.partial(_state_init, cfg=cfg, batch=batch,
                            max_len=max_len, device=device, ragged=ragged,
                            page_size=page_size, num_pages=num_pages)
    cache = {"blocks": tuple(one(kind, layers=R) for kind in pat),
             "tail": tuple(one(kind) for kind in tail)}
    if "moe" in pat and cfg.num_dense_layers:
        cache["dense_prefix"] = tuple(one("attn")
                                      for _ in range(cfg.num_dense_layers))
    return cache


def _layer_axis(key: str) -> int:
    """1 for the stacked leaves under "blocks" (their layer axis first),
    0 under "tail" and "dense_prefix"."""
    return 1 if key == "blocks" else 0


def _caches(cache):
    """Every layer's cache record, in the order the forward runs them."""
    return (cache.get("dense_prefix", ()) + cache["blocks"] + cache["tail"])


def cache_scatter(big, sub, slots: torch.Tensor):
    """Copy the batch rows of a sub-batch ragged cache into slots of a big
    one, in place: big[..., slots[i], :, :L] = sub[..., i] for every plane,
    where L, the sub-batch cache's max_len, is at most the big one's; the
    per-slot lengths follow.  A slot's bytes up to its length are then those
    of the reference's whole-row scatter (what lies past it is never read).
    `slots` is an (n,) int64 device tensor."""
    for b, s in zip(_caches(big), _caches(sub)):
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
    "blocks" carry the layer axis (page axis 1), "tail" and "dense_prefix"
    pools do not."""
    for key, pools in cache.items():
        for pool in pools:
            A.copy_pages(pool, src, dst, page_axis=_layer_axis(key))
    return cache


def cache_fetch_pages(cache, pages):
    """Gather pages `pages[i]` out of every layer's paged pool: a tree of
    the cache's structure whose pools are replaced by the gathered pages
    (page axis 1 under "blocks", 0 under "tail" and "dense_prefix") and
    whose other leaves are None.  One fetch covers the stack, since a slot's table row names
    the same pages in every layer."""
    def visit(node, axis):
        if isinstance(node, A.PagedKVCache):
            return A.fetch_pages(node, pages, page_axis=axis)
        if isinstance(node, (tuple, list)):
            return type(node)(visit(v, axis) for v in node)
        return None

    return {k: visit(v, _layer_axis(k)) for k, v in cache.items()}


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

    for k in sorted(cache):        # blocks, dense_prefix, tail
        visit(cache[k], _layer_axis(k))
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
        visit(v, data[k], _layer_axis(k))
    return cache


def _index(tree, r: int):
    if isinstance(tree, dict):
        return {k: _index(v, r) for k, v in tree.items()}
    if isinstance(tree, (A.KVCache, A.PagedKVCache)):
        return tree.layer(r)
    return tree[r]


def _block_fwd_serve(kind: str, params, x, state, offset, cfg: ModelConfig,
                     **kw) -> torch.Tensor:
    if kind == "rglru":
        if kw["seq_lens"] is not None or kw["pages"] is not None:
            raise NotImplementedError("RG-LRU layers serve the classic path only")
        return blocks.rglru_block_fwd_serve(params, x, state, cfg)
    window = cfg.window if kind == "attn_local" else 0
    causal = True if kind == "attn_local" else cfg.causal
    return blocks.attn_block_fwd_serve(params, x, state, offset, cfg,
                                       window=window, causal=causal, **kw)


def _embed_inputs(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig
                  ) -> torch.Tensor:
    """The step's input embeddings (B, S, D) in the compute dtype.  Where the
    config has image patches and the batch carries `image_embeds` (B, P0,
    D), the patch embeddings, cast to the compute dtype, go through the
    `img_proj` PIM linear and are added to the first P = min(P0, S)
    positions of the step, as the reference's stub VLM fusion does: at
    columns 0..P-1 of whatever step carries them, whatever its offset (the
    classic path passes them to the prefill only)."""
    x = L.embed_apply(params["embed"], batch["tokens"],
                      getattr(torch, cfg.compute_dtype))
    if cfg.num_image_patches and "image_embeds" in batch:
        img = pim.pim_linear_apply(params["img_proj"],
                                   batch["image_embeds"].to(x.dtype), cfg.pim,
                                   cfg.pim_linears)
        P = min(cfg.num_image_patches, x.shape[1])
        x[:, :P] += img[:, :P]
    return x


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
    per step.  A MoE arch's dense prefix layers run first.  A batch may
    carry `image_embeds` (see `_embed_inputs`)."""
    pat, R, tail = pattern_layout(cfg)
    tokens = batch["tokens"]
    B, S = tokens.shape
    ragged = isinstance(offset, torch.Tensor)
    x = _embed_inputs(params, batch, cfg)
    kw = dict(seq_lens=seq_lens, pages=pages, decode_rows=decode_rows,
              verify_len=verify_len)
    for p, c in zip(params.get("dense_prefix", ()), cache.get("dense_prefix", ())):
        x = _block_fwd_serve("attn", p, x, c, offset, cfg, **kw)
    for r in range(R):
        for j, kind in enumerate(pat):
            x = _block_fwd_serve(kind, _index(params["blocks"][j], r), x,
                                 _index(cache["blocks"][j], r), offset, cfg,
                                 **kw)
    for i, kind in enumerate(tail):
        x = _block_fwd_serve(_moe_kind_for_layer(cfg, kind, R * len(pat) + i),
                             params["tail"][i], x, cache["tail"][i], offset,
                             cfg, **kw)
    if pages is None:
        for c in _caches(cache):
            if not isinstance(c, A.KVCache):
                continue            # an RG-LRU state has no length
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
