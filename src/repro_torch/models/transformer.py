"""Model assembly for attention, MoE, hybrid RG-LRU, encoder-decoder and
xLSTM stacks: parameter init, the serve state and the serve forward (with a
VLM's image patch embeddings projected into the first positions of a
prompt, and an encoder-decoder's frames encoded at its prefill); and the
training forward (`forward_hidden`, `forward_train`) of attention, MoE
(with the load-balance aux term and the dense prefix), sliding-window,
encoder-decoder and image-patch stacks.

Counterpart of the JAX package's `models/transformer.py` for serving:
attention and MoE stacks on the classic dense cache, ragged slots and the
paged pool; sliding-window attention (`attn_local`, ring caches past the
window), RG-LRU blocks, whisper's cross-attention decoder blocks
(`xattn`, with the bidirectional encoder `encode`) and xLSTM's mLSTM and
sLSTM blocks on the classic path.
Parameters keep the reference's tree: `"blocks"` is a tuple with one stack
per block-pattern position, each leaf carrying a leading layer-repetition
axis; `"tail"` holds the unrolled remainder and, for a MoE arch with dense
leading layers (deepseek-moe), `"dense_prefix"` those layers, which run
first.  The reference scans over the layer axis; here it is a Python loop
over layer views.  Serve-state trees carry the same keys; leaves under
"blocks" have the layer axis first (batch or page axis 1), those under
"tail" and "dense_prefix" do not (axis 0).
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core import attention as A
from repro_torch.core import pim
from repro_torch.models import blocks
from repro_torch.models import layers as L
from repro_torch.models import moe as M


SERVED_KINDS = ("attn", "attn_local", "moe", "rglru", "xattn", "enc_attn",
                "mlstm", "slstm")
# the kinds whose state is a recurrence or a cross cache: the classic path only
CLASSIC_ONLY = ("rglru", "xattn", "mlstm", "slstm")


def check_supported(cfg: ModelConfig) -> None:
    """The port serves attention, sliding-window attention, MoE, RG-LRU,
    cross-attention decoder and xLSTM (mLSTM, sLSTM) stacks, with image
    patch embeddings (the VLM stub) or an encoder over frame embeddings
    (the audio stub), and rope, absolute or no positions; anything else
    raises."""
    unsupported = []
    kinds = set(cfg.block_pattern) - set(SERVED_KINDS)
    if kinds:
        unsupported.append(f"block kinds {sorted(kinds)}")
    if "moe" in cfg.block_pattern and not cfg.moe.num_experts:
        unsupported.append("a moe block without experts")
    if cfg.is_encoder_decoder and "xattn" not in cfg.block_pattern:
        unsupported.append("an encoder without cross-attention blocks")
    if cfg.pos not in ("rope", "absolute", "none"):
        unsupported.append(f"pos={cfg.pos!r}")
    if unsupported:
        raise NotImplementedError(
            f"{cfg.name}: the port does not serve {', '.join(unsupported)} yet")


UNTRAINED_KINDS = ("rglru", "mlstm", "slstm")


def check_trainable(cfg: ModelConfig) -> None:
    """The port trains every served stack but the recurrent ones: `attn`,
    `attn_local`, `moe` (with its aux term and dense prefix), `xattn` over
    the `enc_attn` encoder, with image patches or not; an RG-LRU, mLSTM
    or sLSTM block raises (ROADMAP.md §1 item 8)."""
    check_supported(cfg)
    kinds = set(cfg.block_pattern) & set(UNTRAINED_KINDS)
    if kinds:
        raise NotImplementedError(
            f"{cfg.name}: the port does not train block kinds "
            f"{sorted(kinds)} yet (ROADMAP.md §1 item 8)")


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


def _norm_init(ones, cfg: ModelConfig, lead=()):
    """A norm's {"scale"} (ones), and for a layernorm its {"bias"} (zeros)."""
    p = {"scale": ones(lead + (cfg.d_model,))}
    if cfg.norm == "layernorm":
        p["bias"] = ones(lead + (cfg.d_model,)).zero_()
    return p


def _block_init(kind: str, normal, ones, linear, expert_linear,
                cfg: ModelConfig, lead):
    """One block, or a stack of them (`lead` the layer axis).  An attention
    block (`attn`, `attn_local`, the encoder's `enc_attn`) carries an MLP,
    a `moe` one a MoE FFN in its place; the FFN is drawn before the
    attention, as every earlier slice drew it (the weights of a seed stay
    those of earlier runs).  A cross-attention block (`xattn`) also carries
    `norm_x` and the `xattn` linears, drawn last."""
    d, dh, f = cfg.d_model, cfg.resolved_head_dim, cfg.d_ff
    nq, nkv = cfg.num_heads, cfg.num_kv_heads

    def lin(d_in, d_out, bias=False):
        return linear(lead, d_in, d_out, 1.0 / d_in ** 0.5, bias)

    def attn():
        return {"wq": lin(d, nq * dh, cfg.qkv_bias),
                "wk": lin(d, nkv * dh, cfg.qkv_bias),
                "wv": lin(d, nkv * dh, cfg.qkv_bias),
                "wo": lin(nq * dh, d)}

    def mlp():
        m = {"w_in": lin(d, f), "w_out": lin(f, d)}
        if cfg.activation in ("swiglu", "geglu"):
            m = {"w_gate": lin(d, f), **m}
        return m

    if kind == "rglru":
        return _rglru_init(normal, ones, lin, mlp, cfg, lead)
    if kind == "mlstm":
        return _mlstm_init(ones, lin, cfg, lead)
    if kind == "slstm":
        return _slstm_init(normal, ones, lin, cfg, lead)
    if kind == "moe":
        ffn = {"moe": M.moe_ffn_init(normal, cfg, lead, expert_linear)}
    else:
        ffn = {"mlp": mlp()}
    p = {
        "norm1": _norm_init(ones, cfg, lead),
        "attn": attn(),
        "norm2": _norm_init(ones, cfg, lead),
        **ffn,
    }
    if kind == "xattn":
        p["norm_x"] = _norm_init(ones, cfg, lead)
        p["xattn"] = attn()
    return p


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


def _mlstm_init(ones, lin, cfg: ModelConfig, lead):
    """An mLSTM block in the reference's tree: PIM linears w_up, w_gate
    (d -> di = 2 d), wq, wk, wv (di -> di), w_down (di -> d); raw float32
    gate matrices w_igate, w_fgate (di, H) and biases b_igate, b_fgate
    (H,), zeros but b_fgate = 3.0, as the reference's; the out-norm over
    di."""
    d, H = cfg.d_model, cfg.num_heads
    di = 2 * d
    p = {"norm": {"scale": ones(lead + (d,))},
         "w_up": lin(d, di), "w_gate": lin(d, di),
         "wq": lin(di, di), "wk": lin(di, di), "wv": lin(di, di)}
    p.update(w_igate=ones(lead + (di, H)).zero_(),
             w_fgate=ones(lead + (di, H)).zero_(),
             b_igate=ones(lead + (H,)).zero_(),
             b_fgate=ones(lead + (H,)) * 3.0)
    return {**p, "out_norm": {"scale": ones(lead + (di,))},
            "w_down": lin(di, d)}


def _slstm_init(normal, ones, lin, cfg: ModelConfig, lead):
    """An sLSTM block in the reference's tree: raw float32 input matrices
    w_z, w_i, w_f, w_o (d, d) N(0, 1 / d), recurrent blocks r_* (H, dh,
    dh) and biases b_* (d,), zeros but b_f = 3.0, as the reference's;
    norm2 and a GELU MLP of width max(d_ff, 2 d) (PIM linears)."""
    d, H = cfg.d_model, cfg.num_heads
    dh, f = d // H, max(cfg.d_ff, 2 * d)
    p = {"norm": {"scale": ones(lead + (d,))}}
    for g in ("z", "i", "f", "o"):
        p[f"w_{g}"] = normal(lead + (d, d), 1.0 / d ** 0.5)
    for g in ("z", "i", "f", "o"):
        p[f"r_{g}"] = ones(lead + (H, dh, dh)).zero_()
    for g in ("z", "i", "f", "o"):
        p[f"b_{g}"] = ones(lead + (d,)) * (3.0 if g == "f" else 0.0)
    return {**p, "norm2": {"scale": ones(lead + (d,))},
            "mlp": {"w_in": lin(d, f), "w_out": lin(f, d)}}


def init_params(generator: torch.Generator, cfg: ModelConfig,
                device, expert_linear=None, deploy=None) -> Dict[str, Any]:
    """Random parameters in the reference's tree, drawn on `device` from
    `generator` (which must live on that device).  Every linear is an fp
    {"w"} drawn whole, N(0, scale^2), with zero biases, and passed through
    `deploy` when it is given, but a stack of experts (a `lead` of layer
    and expert axes), which `expert_linear(lead, d_in, d_out, scale)`
    makes when it is given.  A config with image patches also gets
    `img_proj`, a (d_model, d_model) linear without bias, drawn after the
    head table; one with absolute positions `pos_embed`, a float32
    (max_seq_len, d_model) table N(0, 0.02^2) drawn there too; an
    encoder-decoder `enc_blocks` (a stack of num_encoder_layers `enc_attn`
    blocks) and `enc_norm`, drawn last.  So every other config's draws stay
    as they were."""
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
    if cfg.pos == "absolute":
        params["pos_embed"] = normal((cfg.max_seq_len, cfg.d_model), 0.02)
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
    params["final_norm"] = _norm_init(ones, cfg)
    if cfg.is_encoder_decoder:
        params["enc_blocks"] = blk("enc_attn", lead=(cfg.num_encoder_layers,))
        params["enc_norm"] = _norm_init(ones, cfg)
    return params


def _state_init(kind: str, cfg: ModelConfig, batch: int, max_len: int,
                device, layers=None, ragged: bool = False,
                page_size: int = 0, num_pages: int = 0):
    """One layer's serve state, or a stack of them (`layers`): a KV cache
    (dense, ragged or a paged pool) for an attention kind, {"h", "conv"}
    for an RG-LRU block, {"self", "cross"} for a cross-attention block: a
    cache of max_len tokens and one of encoder_seq_len, both int8 whatever
    cfg.kv_bits says, as the reference's; float32 {"C" (B, H, dh, dh), "n"
    (B, H, dh), "m" (B, H) = -1e30} for an mLSTM block (dh = 2 d_model /
    H) and {"c", "n" = 1, "m", "h"} (B, d_model) for an sLSTM block.  A
    sliding-window layer whose context outgrows its window (max_len >
    window) gets a ring of `window` slots, always int8, as the
    reference's."""
    dh = cfg.resolved_head_dim
    if page_size:
        if kind not in ("attn", "moe"):
            raise NotImplementedError(
                f"paged KV serves attention stacks only (got {kind!r})")
        return A.init_paged_kv_cache(num_pages, page_size, cfg.num_kv_heads,
                                     dh, kv_bits=cfg.kv_bits, device=device,
                                     layers=layers)
    if kind in ("xattn", "mlstm", "slstm") and ragged:
        raise NotImplementedError(f"{kind} layers serve the classic path only")
    if kind == "xattn":
        return {name: A.init_kv_cache(batch, n, cfg.num_kv_heads, dh,
                                      device=device, layers=layers)
                for name, n in (("self", max_len),
                                ("cross", max(cfg.encoder_seq_len, 1)))}
    lead = () if layers is None else (layers,)
    z = dict(dtype=torch.float32, device=device)
    if kind == "rglru":
        w = cfg.lru_width or cfg.d_model
        return {"h": torch.zeros(lead + (batch, w), **z),
                "conv": torch.zeros(lead + (batch, cfg.conv1d_width - 1, w), **z)}
    if kind == "mlstm":
        H = cfg.num_heads
        dh = 2 * cfg.d_model // H
        return {"C": torch.zeros(lead + (batch, H, dh, dh), **z),
                "n": torch.zeros(lead + (batch, H, dh), **z),
                "m": torch.full(lead + (batch, H), -1e30, **z)}
    if kind == "slstm":
        shape = lead + (batch, cfg.d_model)
        return {"c": torch.zeros(shape, **z), "n": torch.ones(shape, **z),
                "m": torch.zeros(shape, **z), "h": torch.zeros(shape, **z)}
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
    an RG-LRU, mLSTM or sLSTM layer its recurrent state.  `ragged` gives
    every cache (B,) per-slot lengths (all 0: every slot empty), the
    layout the continuous-batching scheduler needs.  With `page_size` every layer
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


def _layer_views(tree, layers: int) -> list:
    """The `layers` per-layer views of a stacked parameter tree, one
    `torch.unbind` per leaf: their backward writes each leaf's gradient
    once (indexing layer by layer would write a zero-filled stack per
    layer)."""
    if isinstance(tree, dict):
        views = {k: _layer_views(v, layers) for k, v in tree.items()}
        return [{k: v[r] for k, v in views.items()} for r in range(layers)]
    return list(torch.unbind(tree, 0))


def _block_fwd_train(kind: str, params, x, pos_ids, cfg: ModelConfig,
                     enc_out=None):
    """One block's training forward, (x, aux), dispatched as the
    reference's."""
    if kind in ("attn", "moe"):
        return blocks.attn_block_fwd_train(params, x, pos_ids, cfg,
                                           causal=cfg.causal)
    if kind == "attn_local":
        return blocks.attn_block_fwd_train(params, x, pos_ids, cfg,
                                           window=cfg.window, causal=True)
    if kind == "enc_attn":
        return blocks.attn_block_fwd_train(params, x, pos_ids, cfg,
                                           causal=False)
    if kind == "xattn":
        return blocks.xattn_block_fwd_train(params, x, enc_out, pos_ids, cfg)
    if kind in UNTRAINED_KINDS:
        raise NotImplementedError(f"{cfg.name}: the port does not train "
                                  f"{kind} blocks yet (ROADMAP.md §1 item 8)")
    raise ValueError(kind)


def forward_hidden(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig):
    """Final normed hidden states (B, S, D) and the float32 aux loss, as
    the reference's: the loss computes the chunked cross-entropy from them
    without the full logits.  A MoE arch's dense prefix runs first,
    unrolled and not recomputed, its aux dropped; then the stacked blocks
    (with `cfg.remat != "none"` each recomputed in the backward,
    `torch.utils.checkpoint`, the counterpart of the reference's per-block
    `jax.checkpoint`: no value changes) and the unrolled tail.  The aux
    terms add up in float32 in layer order, a repetition's pattern summed
    from zero before it joins the total, as the reference's scan does.  An
    encoder-decoder encodes `batch["frames"]` once, outside the blocks'
    checkpoints, and each `xattn` block takes the encoder output as an
    argument of its checkpointed call.  The reference's sharding
    constraints are left out (a single device)."""
    check_trainable(cfg)
    pat, R, tail = pattern_layout(cfg)
    x = _embed_inputs(params, batch, cfg)
    pos_ids = torch.arange(x.shape[1], device=x.device)
    enc_out = None
    if cfg.is_encoder_decoder:
        enc_out = encode(params, batch["frames"], cfg)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)

    def block(kind):
        def f(p, x, enc_out):
            return _block_fwd_train(kind, p, x, pos_ids, cfg, enc_out)
        return f

    for p in params.get("dense_prefix", ()):
        x, _ = _block_fwd_train("attn", p, x, pos_ids, cfg)
    fns = [block(kind) for kind in pat]
    layers = [_layer_views(stack, R) for stack in params["blocks"]]
    aux = zero
    for r in range(R):
        group = zero
        for j in range(len(pat)):
            if cfg.remat != "none":
                x, a = checkpoint(fns[j], layers[j][r], x, enc_out,
                                  use_reentrant=False)
            else:
                x, a = fns[j](layers[j][r], x, enc_out)
            group = group + a
        aux = aux + group
    for i, kind in enumerate(tail):         # unrolled, as the reference's
        x, a = _block_fwd_train(_moe_kind_for_layer(cfg, kind, R * len(pat) + i),
                                params["tail"][i], x, pos_ids, cfg, enc_out)
        aux = aux + a
    return L.norm_apply(params["final_norm"], x, cfg.norm), aux


def forward_train(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig):
    """(logits (B, S, V), aux loss)."""
    x, aux = forward_hidden(params, batch, cfg)
    head = params["embed"] if cfg.tie_embeddings else params["unembed"]
    return L.unembed_apply(head, x), aux


def _index(tree, r: int):
    if isinstance(tree, dict):
        return {k: _index(v, r) for k, v in tree.items()}
    if isinstance(tree, (A.KVCache, A.PagedKVCache)):
        return tree.layer(r)
    return tree[r]


def _block_fwd_serve(kind: str, params, x, state, offset, cfg: ModelConfig,
                     enc_out=None, **kw) -> torch.Tensor:
    if kind in CLASSIC_ONLY:
        if kw["seq_lens"] is not None or kw["pages"] is not None:
            raise NotImplementedError(f"{kind} layers serve the classic path only")
        if kind == "xattn":
            return blocks.xattn_block_fwd_serve(params, x, state, offset, cfg,
                                                enc_out=enc_out)
        fwd = {"rglru": blocks.rglru_block_fwd_serve,
               "mlstm": blocks.mlstm_block_fwd_serve,
               "slstm": blocks.slstm_block_fwd_serve}[kind]
        return fwd(params, x, state, cfg)
    window = cfg.window if kind == "attn_local" else 0
    causal = True if kind == "attn_local" else cfg.causal
    return blocks.attn_block_fwd_serve(params, x, state, offset, cfg,
                                       window=window, causal=causal, **kw)


def _embed_inputs(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
                  offset=0) -> torch.Tensor:
    """The step's input embeddings (B, S, D) in the compute dtype.  With
    absolute positions the rows of the float32 `pos_embed` table at the
    step's positions, cast to the compute dtype, are added: rows [offset,
    offset + S) for an int offset, the start clamped into the table as the
    reference's `dynamic_slice` clamps it; for (B,) offsets row b's
    positions offset_b + j, each clamped into the table.  Where the config
    has image patches and the batch carries `image_embeds` (B, P0, D), the
    patch embeddings, cast to the compute dtype, go through the `img_proj`
    PIM linear and are added to the first P = min(P0, S) positions of the
    step, as the reference's stub VLM fusion does: at columns 0..P-1 of
    whatever step carries them, whatever its offset (the classic path
    passes them to the prefill only).  The add is in place: no op before
    it saves `x` for its backward, so a training step takes it, and its
    gradients are those of the reference's `x.at[:, :P].add`."""
    x = L.embed_apply(params["embed"], batch["tokens"],
                      getattr(torch, cfg.compute_dtype))
    if cfg.pos == "absolute":
        table = params["pos_embed"]
        T, S = table.shape[0], x.shape[1]
        if isinstance(offset, torch.Tensor):
            ar = torch.arange(S, device=offset.device)
            pe = table[torch.clamp(offset.long()[:, None] + ar, 0, T - 1)]
        else:
            start = min(max(int(offset), 0), T - S)
            pe = table[start:start + S]
        x = x + pe.to(x.dtype)
    if cfg.num_image_patches and "image_embeds" in batch:
        img = pim.pim_linear_apply(params["img_proj"],
                                   batch["image_embeds"].to(x.dtype), cfg.pim,
                                   cfg.pim_linears)
        P = min(cfg.num_image_patches, x.shape[1])
        x[:, :P] += img[:, :P]
    return x


def encode(params, frames: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The encoder: (B, Se, D) frame embeddings (the conv stem's stub) cast
    to the compute dtype, plus the sinusoid table in that dtype, through
    the `enc_blocks` stack (bidirectional attention blocks) and
    `enc_norm`; (B, Se, D) out.  As the reference's `encode`.  Its layers
    are `_layer_views` of the stack, so a training step writes each
    leaf's gradient once."""
    x = frames.to(getattr(torch, cfg.compute_dtype))
    x = x + L.sinusoidal_positions(x.shape[1], cfg.d_model,
                                   x.device).to(x.dtype)
    for p in _layer_views(params["enc_blocks"], cfg.num_encoder_layers):
        x = blocks.attn_block_fwd_encode(p, x, cfg)
    return L.norm_apply(params["enc_norm"], x, cfg.norm)


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
    carry `image_embeds` (see `_embed_inputs`), and an encoder-decoder's
    `frames` (B, Se, D): the step then encodes them and every
    cross-attention layer writes its cross K/V from the encoder output
    (the classic path passes them to the prefill; later steps read the
    cross caches as written).  A layer's self cache then holds offset + S
    tokens, its cross cache Se."""
    pat, R, tail = pattern_layout(cfg)
    tokens = batch["tokens"]
    B, S = tokens.shape
    ragged = isinstance(offset, torch.Tensor)
    x = _embed_inputs(params, batch, cfg, offset)
    enc_out = None
    if cfg.is_encoder_decoder and "frames" in batch:
        enc_out = encode(params, batch["frames"], cfg)
    kw = dict(seq_lens=seq_lens, pages=pages, decode_rows=decode_rows,
              verify_len=verify_len)
    for p, c in zip(params.get("dense_prefix", ()), cache.get("dense_prefix", ())):
        x = _block_fwd_serve("attn", p, x, c, offset, cfg, **kw)
    for r in range(R):
        for j, kind in enumerate(pat):
            x = _block_fwd_serve(kind, _index(params["blocks"][j], r), x,
                                 _index(cache["blocks"][j], r), offset, cfg,
                                 enc_out=enc_out, **kw)
    for i, kind in enumerate(tail):
        x = _block_fwd_serve(_moe_kind_for_layer(cfg, kind, R * len(pat) + i),
                             params["tail"][i], x, cache["tail"][i], offset,
                             cfg, enc_out=enc_out, **kw)
    if pages is None:
        for c in _caches(cache):
            if isinstance(c, dict) and "cross" in c:
                # a cross-attention layer: the cross cache holds the
                # encoder's Se rows once written, the self cache the rest
                if enc_out is not None:
                    c["cross"].length = enc_out.shape[1]
                c = c["self"]
            if not isinstance(c, A.KVCache):
                continue            # a recurrent state has no length
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
