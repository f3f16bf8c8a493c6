"""The serve-path blocks: attention (`attn`; `attn_local`, its sliding-
window form; `moe`, the same block with a Mixture-of-Experts FFN in place
of the MLP), Griffin's RG-LRU recurrence (`rglru`), whisper's
bidirectional encoder block (`enc_attn`) and cross-attention decoder block
(`xattn`), and xLSTM's mLSTM (`mlstm`) and sLSTM (`slstm`) blocks.

Counterpart of the attention, cross-attention, RG-LRU and xLSTM blocks of
the JAX package's `models/blocks.py`, and of its attention and
cross-attention blocks' training forwards (`attn_block_fwd_train`,
`xattn_block_fwd_train`); attention on three storages: the classic
dense cache (scalar offset), ragged dense slots and the paged pool (per-row
offsets).  Serve-path attention runs the
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


def _ffn(params, x: torch.Tensor, cfg: ModelConfig, with_aux: bool = False):
    """The block's FFN: the MoE layer where the block carries "moe", else
    the MLP.  With `with_aux` (training) it returns (y, aux) as the
    reference's does, aux the MoE load-balance term or a float32 zero;
    serving drops the term."""
    if "moe" in params:
        return M.moe_ffn_apply(params["moe"], x, cfg, with_aux)
    y = L.mlp_apply(params["mlp"], x, cfg)
    if not with_aux:
        return y
    return y, torch.zeros((), dtype=torch.float32, device=x.device)


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


def _ring_attend(q, k, v, cache: A.KVCache, offset: int, cfg: ModelConfig,
                 window: int, causal: bool) -> torch.Tensor:
    """A sliding-window layer over its ring cache, as the reference serves
    it.  Prefill (S > 1, from position 0): banded attention over a
    temporary dense cache of the chunk (on the kernel path kernel 1 with
    `window`), freed when the layer returns, then a ring write of the
    chunk's last W tokens.  Decode: the ring write, then
    `pim_attention_ring` on either attention path."""
    B, S = k.shape[:2]
    if S > 1:
        tmp = A.init_kv_cache(B, S, cfg.num_kv_heads, cfg.resolved_head_dim,
                              device=k.device)
        A.cache_write(tmp, k, v, 0, cfg.pim)
        o = _serve_attend(q, tmp, 0, cfg, window, causal)
        del tmp
        A.cache_write_ring(cache, k, v, 0, cfg.pim)
        return o
    A.cache_write_ring(cache, k, v, offset, cfg.pim)
    return A.pim_attention_ring(q, cache, cfg.pim, cfg.lut, offset, window,
                                out_dtype=getattr(torch, cfg.compute_dtype))


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
    all verified through the split-K decode launch in one step.

    A sliding-window layer (`window` > 0) whose classic cache is a ring
    (it carries `positions`) goes through `_ring_attend`; one whose cache
    holds its whole context attends through the normal branch with the
    window mask.  Paged and ragged storage have no windows here, as in the
    reference."""
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
        if cache.positions is not None:
            raise NotImplementedError("ragged serving has no ring caches")
        A.cache_write_ragged(cache, k, v, offset, cfg.pim, seq_lens)
        if mixed:
            o = _mixed_attend(q, cache, offset, cache.length, seq_lens,
                              decode_rows, cfg, causal, window=window,
                              verify_len=verify_len)
        else:
            o = _serve_attend(q, cache, offset, cfg, window, causal,
                              q_len=seq_lens)
    elif cache.positions is not None:
        o = _ring_attend(q, k, v, cache, offset, cfg, window, causal)
    else:
        A.cache_write(cache, k, v, offset, cfg.pim)
        o = _serve_attend(q, cache, offset, cfg, window, causal)
    o = pim.pim_linear_apply(params["attn"]["wo"], o.reshape(B, S, -1),
                             cfg.pim, cfg.pim_linears)
    x = x + o
    h = L.norm_apply(params["norm2"], x, cfg.norm)
    return x + _ffn(params, h, cfg)


# ---------------------------------------------------------------------------
# whisper: the encoder block and the cross-attention decoder block
# ---------------------------------------------------------------------------
def attn_block_fwd_train(params, x: torch.Tensor, pos_ids: torch.Tensor,
                         cfg: ModelConfig, window: int = 0,
                         causal: bool = True):
    """One attention block over the whole (B, S, D) sequence, as the
    reference's training forward: its attention is `fp_attention` (float32
    softmax, no KV cache), plain arithmetic in the reference too, and its
    PIM linears carry the straight-through gradients.  Returns (x, aux),
    aux the MoE load-balance term of a `moe` block, else a float32 zero.
    A sliding-window block (`attn_local`) trains with `window` and
    causal."""
    B, S, _ = x.shape
    h = L.norm_apply(params["norm1"], x, cfg.norm)
    q, k, v = _qkv(params["attn"], h, cfg, pos_ids)
    o = A.fp_attention(q, k, v, q_offset=0, causal=causal, window=window)
    x = x + pim.pim_linear_apply(params["attn"]["wo"], o.reshape(B, S, -1),
                                 cfg.pim, cfg.pim_linears)
    h = L.norm_apply(params["norm2"], x, cfg.norm)
    y, aux = _ffn(params, h, cfg, with_aux=True)
    return x + y, aux


def attn_block_fwd_encode(params, x: torch.Tensor,
                          cfg: ModelConfig) -> torch.Tensor:
    """One encoder block: `attn_block_fwd_train(causal=False)`'s output."""
    pos_ids = torch.arange(x.shape[1], device=x.device)
    return attn_block_fwd_train(params, x, pos_ids, cfg, causal=False)[0]


def xattn_block_fwd_train(params, x: torch.Tensor, enc_out: torch.Tensor,
                          pos_ids: torch.Tensor, cfg: ModelConfig):
    """One decoder block of whisper over the whole sequence, as the
    reference's training forward: causal self-attention through
    `fp_attention`, then cross-attention of the `norm_x`-normed stream
    over `enc_out` (B, Se, D), whose K/V this layer's `xattn` wk / wv
    project on every call (no cache), then the MLP.  Returns (x, aux)."""
    B, S, _ = x.shape
    p, en, dh = cfg.pim, cfg.pim_linears, cfg.resolved_head_dim
    h = L.norm_apply(params["norm1"], x, cfg.norm)
    q, k, v = _qkv(params["attn"], h, cfg, pos_ids)
    o = A.fp_attention(q, k, v, q_offset=0, causal=True)
    x = x + pim.pim_linear_apply(params["attn"]["wo"], o.reshape(B, S, -1),
                                 p, en)
    h = L.norm_apply(params["norm_x"], x, cfg.norm)
    Se = enc_out.shape[1]
    qx = pim.pim_linear_apply(params["xattn"]["wq"], h, p, en
                              ).reshape(B, S, cfg.num_heads, dh)
    kx = pim.pim_linear_apply(params["xattn"]["wk"], enc_out, p, en
                              ).reshape(B, Se, cfg.num_kv_heads, dh)
    vx = pim.pim_linear_apply(params["xattn"]["wv"], enc_out, p, en
                              ).reshape(B, Se, cfg.num_kv_heads, dh)
    ox = A.fp_attention(qx, kx, vx, q_offset=0, causal=False)
    x = x + pim.pim_linear_apply(params["xattn"]["wo"], ox.reshape(B, S, -1),
                                 p, en)
    h = L.norm_apply(params["norm2"], x, cfg.norm)
    y, aux = _ffn(params, h, cfg, with_aux=True)
    return x + y, aux


def xattn_block_fwd_serve(params, x: torch.Tensor, state, offset: int,
                          cfg: ModelConfig, enc_out=None) -> torch.Tensor:
    """Prefill or decode of one decoder block of whisper, classic path:
    causal self-attention over `state["self"]` (written at offset), then
    cross-attention of the `norm_x`-normed stream over `state["cross"]`
    (query offset 0, not causal: every encoder position is visible), then
    the MLP.  Both caches are updated in place.

    The cross K/V are the encoder output `enc_out` (B, Se, D) through the
    `xattn` wk / wv linears, quantized and written at position 0 of the
    cross cache, when the step carries it: the classic path's prefill.
    The reference passes `enc_out` to every decode step too and re-projects
    and re-writes the same K/V there; the write is deterministic, so its
    codes and scales are those of the prefill's, and the port writes them
    once and lets decode steps read them.  A step without `enc_out` over a
    cross cache that was never written raises."""
    B, S, _ = x.shape
    p, en, dh = cfg.pim, cfg.pim_linears, cfg.resolved_head_dim
    h = L.norm_apply(params["norm1"], x, cfg.norm)
    q, k, v = _qkv(params["attn"], h, cfg,
                   offset + torch.arange(S, device=x.device))
    A.cache_write(state["self"], k, v, offset, p)
    o = _serve_attend(q, state["self"], offset, cfg, 0, True)
    x = x + pim.pim_linear_apply(params["attn"]["wo"], o.reshape(B, S, -1),
                                 p, en)
    cross = state["cross"]
    if enc_out is not None:
        Se = enc_out.shape[1]
        kx = pim.pim_linear_apply(params["xattn"]["wk"], enc_out, p, en
                                  ).reshape(B, Se, cfg.num_kv_heads, dh)
        vx = pim.pim_linear_apply(params["xattn"]["wv"], enc_out, p, en
                                  ).reshape(B, Se, cfg.num_kv_heads, dh)
        A.cache_write(cross, kx, vx, 0, p)
    elif not cross.length:
        raise ValueError("a cross-attention cache is written by a step that "
                         "carries the batch's frames (the prefill)")
    h = L.norm_apply(params["norm_x"], x, cfg.norm)
    qx = pim.pim_linear_apply(params["xattn"]["wq"], h, p, en
                              ).reshape(B, S, cfg.num_heads, dh)
    ox = _serve_attend(qx, cross, 0, cfg, 0, False)
    x = x + pim.pim_linear_apply(params["xattn"]["wo"], ox.reshape(B, S, -1),
                                 p, en)
    h = L.norm_apply(params["norm2"], x, cfg.norm)
    return x + _ffn(params, h, cfg)


# ---------------------------------------------------------------------------
# the RG-LRU block (Griffin / recurrentgemma): gated linear recurrence + FFN
# ---------------------------------------------------------------------------
_RGLRU_C = 8.0


def _rglru_gates(params, u: torch.Tensor):
    """u: (B, S, w) conv output.  Returns (log_a, b) in float32: Griffin's
    a_t = sigmoid(Lambda)^(c r_t), c = 8, as log a_t = c r_t log
    sigmoid(Lambda), and the input b_t = sqrt(1 - a_t^2) (i_t u_t)."""
    uf = u.float()
    r = torch.sigmoid(uf @ params["w_rec_gate"])
    i = torch.sigmoid(uf @ params["w_input_gate"])
    log_a = _RGLRU_C * r * torch.nn.functional.logsigmoid(params["lambda_p"])
    a2 = torch.exp(2.0 * log_a)
    b = torch.sqrt(torch.clamp_min(1.0 - a2, 1e-8)) * (i * uf)
    return log_a, b


def _causal_conv1d(u: torch.Tensor, conv_w: torch.Tensor,
                   conv_b: torch.Tensor, carry=None):
    """Depthwise causal conv over (B, S, w) u, with the (B, W - 1, w)
    history `carry` (None: zeros).  As the reference: the products promote
    to float32 and are summed from 0, tap by tap, the bias last, then cast
    to u's dtype; the new carry is the last W - 1 inputs in u's dtype."""
    W = conv_w.shape[0]
    B, S, w = u.shape
    pad = (torch.zeros((B, W - 1, w), dtype=u.dtype, device=u.device)
           if carry is None else carry.to(u.dtype))
    ext = torch.cat([pad, u], dim=1)                       # (B, S + W - 1, w)
    out = 0
    for i in range(W):
        out = out + ext[:, i:i + S] * conv_w[i]
    out = out + conv_b
    return out.to(u.dtype), (ext[:, S:] if W > 1 else None)


def _lru_combine(x, y):
    (la1, b1), (la2, b2) = x, y
    return la1 + la2, b1 * torch.exp(la2) + b2


def _associative_scan(la: torch.Tensor, b: torch.Tensor):
    """The inclusive scan of `_lru_combine` over dim 1, by the reference's
    odd/even recursion (`lax.associative_scan`): log-depth, a few ops a
    level, and the reference's order of float32 operations."""
    n = la.shape[1]
    if n < 2:
        return la, b
    odd = _associative_scan(*_lru_combine((la[:, 0:-1:2], b[:, 0:-1:2]),
                                          (la[:, 1::2], b[:, 1::2])))
    tail = (la[:, 2::2], b[:, 2::2])
    if n % 2 == 0:
        even = _lru_combine((odd[0][:, :-1], odd[1][:, :-1]), tail)
    else:
        even = _lru_combine(odd, tail)
    out = []
    for x, e, o in zip((la, b), even, odd):
        y = torch.empty_like(x)
        y[:, 0::2] = torch.cat([x[:, :1], e], dim=1)
        y[:, 1::2] = o
        out.append(y)
    return tuple(out)


def _lru_scan(log_a: torch.Tensor, b: torch.Tensor,
              h0: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t over dim 1 from the (B, w) state h0."""
    la, bb = _associative_scan(log_a, b)
    return bb + torch.exp(la) * h0[:, None]


def rglru_block_fwd_serve(params, x: torch.Tensor, state,
                          cfg: ModelConfig) -> torch.Tensor:
    """Prefill or decode of one RG-LRU block from its state {"h": (B, w)
    f32, "conv": (B, W - 1, w) f32}, which is updated in place.  The
    conv weights and the gates' (w, w) matrices are raw float32 leaves;
    w_x, w_gate and w_out are PIM linears."""
    p, en = cfg.pim, cfg.pim_linears
    h = L.norm_apply(params["norm"], x, cfg.norm)
    u = pim.pim_linear_apply(params["w_x"], h, p, en)
    gate = L.gelu(pim.pim_linear_apply(params["w_gate"], h, p, en))
    u, conv = _causal_conv1d(u, params["conv_w"], params["conv_b"],
                             carry=state["conv"])
    log_a, b = _rglru_gates(params, u)
    hseq = _lru_scan(log_a, b, state["h"])
    state["h"].copy_(hseq[:, -1])
    state["conv"].copy_(conv.float())
    y = pim.pim_linear_apply(params["w_out"], hseq.to(x.dtype) * gate, p, en)
    x = x + y
    h = L.norm_apply(params["norm2"], x, cfg.norm)
    return x + L.mlp_apply(params["mlp"], h, cfg)


# ---------------------------------------------------------------------------
# xLSTM: the mLSTM block (matrix memory, chunked scan) and the sLSTM block
# (scalar memory, sequential recurrence)
# ---------------------------------------------------------------------------
def _time_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last dim.  On the card in a fixed pairwise order
    (`layers.pairwise_row_sum`), so a row's sum never depends on the rows
    beside it; the CPU keeps torch's sum."""
    if not x.is_cuda:
        return x.sum(-1)
    return L.pairwise_row_sum(x)[..., 0]


def _mlstm_qkv_gates(params, x: torch.Tensor, cfg: ModelConfig):
    """The mLSTM's projections: the output gate z, and over the
    up-projection u (PIM linears from d_model to 2 d_model) q, k, v (PIM
    linears, (B, S, H, dh)) and the float32 log input and forget gates (B,
    S, H) from u's raw float32 gate matrices: log_f = log sigmoid(.) as
    the reference's -softplus(-.)."""
    B, S, _ = x.shape
    p, en = cfg.pim, cfg.pim_linears
    h = L.norm_apply(params["norm"], x, cfg.norm)
    u = pim.pim_linear_apply(params["w_up"], h, p, en)
    z = pim.pim_linear_apply(params["w_gate"], h, p, en)
    H = cfg.num_heads
    dh = u.shape[-1] // H
    q = pim.pim_linear_apply(params["wq"], u, p, en).reshape(B, S, H, dh)
    k = pim.pim_linear_apply(params["wk"], u, p, en).reshape(B, S, H, dh)
    v = pim.pim_linear_apply(params["wv"], u, p, en).reshape(B, S, H, dh)
    uf = u.float()
    log_i = uf @ params["w_igate"] + params["b_igate"]
    log_f = -L.softplus(-(uf @ params["w_fgate"] + params["b_fgate"]))
    return z, q, k, v, log_i, log_f


_MLSTM_CHUNK = 1024


def _mlstm_chunk_scan(q, k, v, log_i, log_f, state, chunk: int) -> torch.Tensor:
    """The chunkwise-stabilized mLSTM, the reference's linear-attention
    chunked form: q, k, v (B, S, H, dh), log_i / log_f (B, S, H) float32,
    from `state` {"C" (B, H, dh, dh), "n" (B, H, dh), "m" (B, H)}, float32,
    which is updated in place.  S is cut into chunks of T = min(chunk, S)
    steps, the last padded (its steps carry log_i = -1e30: no input).
    Within a chunk the (T, T) log weights F_t - F_s + log_i_s (s <= t, F
    the inclusive sum of log_f) against the carried state's weight F_t +
    m, stabilized by their maximum m_t; the chunk's end state folds the
    carried one and the chunk's keys and values in.  Returns h (B, S, H,
    dh) in q's dtype.  Sums over time are row-local: F by
    `layers.blocked_cumsum` (XLA's order of `jnp.cumsum`), the weights'
    row sums by `_time_sum`."""
    B, S, H, dh = q.shape
    T = min(chunk, S)
    pad = (-S) % T
    if pad:
        zpad = (0, 0, 0, 0, 0, pad)
        q, k, v = (torch.nn.functional.pad(a, zpad) for a in (q, k, v))
        log_i = torch.nn.functional.pad(log_i, (0, 0, 0, pad), value=-1e30)
        log_f = torch.nn.functional.pad(log_f, (0, 0, 0, pad))
    C, n, m = state["C"], state["n"], state["m"]
    causal = torch.ones((T, T), dtype=torch.bool, device=q.device).tril()
    hs = []
    for c0 in range(0, S + pad, T):
        # (B, H, T, dh) and (B, H, T) views of the chunk, in float32
        qt = q[:, c0:c0 + T].transpose(1, 2).float()
        kt = k[:, c0:c0 + T].transpose(1, 2).float() / (dh ** 0.5)
        vt = v[:, c0:c0 + T].transpose(1, 2).float()
        li = log_i[:, c0:c0 + T].transpose(1, 2)
        F = L.blocked_cumsum(log_f[:, c0:c0 + T].transpose(1, 2))
        Lw = F[..., :, None] - F[..., None, :] + li[..., None, :]   # (B, H, T, T)
        Lw = torch.where(causal, Lw, -torch.inf)
        G = F + m[..., None]                                       # (B, H, T)
        m_t = torch.maximum(Lw.amax(-1), G)
        D = torch.exp(Lw - m_t[..., None])
        g = torch.exp(G - m_t)
        w = (qt @ kt.transpose(-1, -2)) * D
        num = w @ vt + g[..., None] * (qt @ C)
        den_s = _time_sum(w) + g * (qt @ n[..., None])[..., 0]
        den = torch.maximum(den_s.abs(), torch.exp(-m_t))
        hs.append((num / den[..., None]).transpose(1, 2).to(q.dtype))
        # the state at the chunk's end
        F_T = F[..., -1]                                           # (B, H)
        lw_end = F_T[..., None] - F + li                           # (B, H, T)
        m_new = torch.maximum(F_T + m, lw_end.amax(-1))
        c_old = torch.exp(F_T + m - m_new)
        wts = torch.exp(lw_end - m_new[..., None])
        kw = kt * wts[..., None]
        C.mul_(c_old[..., None, None]).add_(kw.transpose(-1, -2) @ vt)
        n.mul_(c_old[..., None]).add_(_time_sum(kw.transpose(-1, -2)))
        m.copy_(m_new)
    return torch.cat(hs, dim=1)[:, :S]


def mlstm_block_fwd_serve(params, x: torch.Tensor, state,
                          cfg: ModelConfig) -> torch.Tensor:
    """Prefill or decode of one mLSTM block from its state {"C", "n",
    "m"} (float32, updated in place): the chunk scan over q, k, v and the
    gates, an RMSNorm of h over the inner width, times silu(z), `w_down`
    and the residual.  Six PIM linears (w_up, w_gate, wq, wk, wv, w_down);
    the gate matrices and biases are raw float32 leaves."""
    B, S, _ = x.shape
    z, q, k, v, log_i, log_f = _mlstm_qkv_gates(params, x, cfg)
    h = _mlstm_chunk_scan(q, k, v, log_i, log_f, state, _MLSTM_CHUNK)
    h = L.norm_apply(params["out_norm"], h.reshape(B, S, -1).to(x.dtype),
                     "rmsnorm")
    out = h * L.silu(z)
    return x + pim.pim_linear_apply(params["w_down"], out, cfg.pim,
                                    cfg.pim_linears)


_SLSTM_GATES = ("z", "i", "f", "o")
# a prefill of at least this many tokens on the card replays a CUDA graph
# of one recurrent step (`_slstm_replayed`); shorter ones loop
_SLSTM_GRAPH_STEPS = 16


def _slstm_step(pre_t, r, c, n, m, h):
    """One sLSTM step: the step's input pre-activations pre_t (4, B, d)
    plus the block-diagonal recurrent products h R_* (one (dh, dh) block a
    head; the four gates' blocks in one product, r (H, dh, 4 dh)), the
    exponential input and forget gates stabilized by m, n kept at least
    1e-6.  Returns the new (c, n, m, h)."""
    B, d = h.shape
    H, dh = r.shape[:2]
    rec = torch.bmm(h.view(B, H, dh).transpose(0, 1), r)           # (H, B, 4 dh)
    rec = rec.view(H, B, 4, dh).permute(2, 1, 0, 3).reshape(4, B, d)
    z = torch.tanh(pre_t[0] + rec[0])
    lo_i = pre_t[1] + rec[1]
    lo_f = pre_t[2] + rec[2]
    o = L.sigmoid(pre_t[3] + rec[3])
    log_f = -L.softplus(-lo_f)
    m_new = torch.maximum(log_f + m, lo_i)
    i_ = torch.exp(lo_i - m_new)
    f_ = torch.exp(log_f + m - m_new)
    c = f_ * c + i_ * z
    n = torch.clamp_min(f_ * n + i_, 1e-6)
    return c, n, m_new, o * (c / n)


def _slstm_replayed(pre, r, st, hs) -> list:
    """The steps of `pre` (S, 4, B, d) from the state st [c, n, m, h],
    replayed from a CUDA graph of one `_slstm_step`: the same kernels on
    the same shapes, so the same bits as the loop, in three launches a
    token (the step's input in, the replay, h out) where a step launches
    about 35.  Writes h into hs (B, S, d); returns the end state."""
    g = torch.empty_like(pre[0])
    work = [x.clone() for x in st]

    def step():
        for w, v in zip(work, _slstm_step(g, r, *work)):
            w.copy_(v)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):        # cuBLAS's lazy set-up, outside the capture
        g.copy_(pre[0])
        step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        step()
    for w, x in zip(work, st):           # undo the warm-up step
        w.copy_(x)
    for t in range(pre.shape[0]):
        g.copy_(pre[t])
        graph.replay()
        hs[:, t].copy_(work[3])
    return work


def _slstm_scan(params, x: torch.Tensor, state,
                cfg: ModelConfig) -> torch.Tensor:
    """The sLSTM recurrence over x (B, S, d), one `_slstm_step` per token,
    from `state` {"c", "n", "m", "h"} (B, d) float32, updated in place: the
    input products x W_* + b_* in float32 for the whole sequence, then the
    steps in order (on the card a prefill replays a CUDA graph of a step).
    Returns the step outputs h (B, S, d) in x's dtype."""
    B, S, d = x.shape
    xf = x.float()
    pre = torch.stack([xf @ params[f"w_{g}"] + params[f"b_{g}"]
                       for g in _SLSTM_GATES]).permute(2, 0, 1, 3).contiguous()
    r = torch.cat([params[f"r_{g}"] for g in _SLSTM_GATES], dim=-1)
    st = [state[f] for f in ("c", "n", "m", "h")]
    hs = torch.empty((B, S, d), dtype=torch.float32, device=x.device)
    if x.is_cuda and S >= _SLSTM_GRAPH_STEPS:
        st = _slstm_replayed(pre, r, st, hs)
    else:
        for t in range(S):
            st = _slstm_step(pre[t], r, *st)
            hs[:, t] = st[3]
    for f, val in zip(("c", "n", "m", "h"), st):
        state[f].copy_(val)
    return hs.to(x.dtype)


def slstm_block_fwd_serve(params, x: torch.Tensor, state,
                          cfg: ModelConfig) -> torch.Tensor:
    """Prefill or decode of one sLSTM block from its state (updated in
    place): the recurrence over the normed input and the residual, then
    the GELU MLP (PIM linears w_in, w_out of width 2 d_model) and its
    residual.  The gates' (d, d) input matrices and (H, dh, dh) recurrent
    blocks are raw float32 leaves."""
    h = L.norm_apply(params["norm"], x, cfg.norm)
    x = x + _slstm_scan(params, h, state, cfg)
    h = L.norm_apply(params["norm2"], x, cfg.norm)
    return x + L.mlp_apply(params["mlp"], h, cfg)
