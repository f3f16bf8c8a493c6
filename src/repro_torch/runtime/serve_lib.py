"""Batched generation over the PIM KV cache.

Counterpart of the JAX package's `runtime/serve_lib.py`:

  * `generate` (classic): equal-length prompts, one prefill, then a Python
    loop of single-token decode steps that update the preallocated cache in
    place.  The reference fuses that loop into one `lax.scan`; capturing it
    in a CUDA graph is later work.
  * `Scheduler` (continuous batching): the KV cache is a set of batch slots
    with per-slot lengths.  Queued requests are admitted into free slots
    (one bucketed, left-aligned prefill per admission wave), decoded
    together in chunks of `decode_chunk` steps in which every slot masks
    and early-outs against its own length, and retired on EOS, budget or
    capacity, which frees the slot at once.  With `page_size > 0` the slots
    share a paged pool: page-granular admission, lazy page allocation at
    decode boundaries, stall-or-evict when the pool runs dry, and pages
    freed at retirement.  `generate(..., continuous_batching=True)` wraps
    one Scheduler run.  On the paged pool the Scheduler can share prompt
    prefixes between requests (refcounted pages, copy-on-write), and on
    either storage it can prefill prompts in chunks inside mixed
    prefill+decode steps, and verify n-gram drafts in speculative steps.

Sampling draws with the reference's threefry keys (`runtime/prng.py`):
classic generation splits one key per step, the Scheduler folds (request
id, token index) into its base key, so sampled streams equal the
reference's token for token.  The Scheduler's host state is numpy, as in
the reference.  Each forward gets its host inputs (tokens, offsets,
lengths, page table, request ids and token indices) in one asynchronous
copy, a decode chunk keeps its evolving lengths on the device, and the
host reads the device once per prefill wave, mixed or speculative step and
chunk.  Under overload it spills an evicted slot's pages to host memory
and restores them on re-admission, bounds its queue, sheds requests past
their deadline, and takes a deterministic fault plan
(`runtime/fault.py`) whose NaN poison quarantines one request.  It serves
4-bit KV pools (`kv_bits=4`), checksums KV pages (`integrity`), degrades
under SLA pressure (`tbt_target_ms`), and snapshots and restores its whole
state through the checkpoint format (`checkpoint/checkpoint.py`).
"""
from __future__ import annotations

import collections
import dataclasses
import os
import pickle
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs.base import ModelConfig
from repro_torch.core import attention as A
from repro_torch.core.attention import TRASH_PAGE
from repro_torch.models import transformer as T
from repro_torch.models.layers import blocked_cumsum
from repro_torch.models.model_zoo import Model, build_model
from repro_torch.runtime import prng
from repro_torch.runtime.fault import CrashInjected, FaultPlan


def kv_bytes_per_token(cfg: ModelConfig) -> int:
    """Device bytes one cached token costs across all layers: K + V values
    at `cfg.kv_bits` (packed two per byte at 4) plus the two f32 scale
    planes, which exist at every precision."""
    hkv = cfg.num_kv_heads
    value_bytes = 2 * hkv * (cfg.resolved_head_dim * cfg.kv_bits // 8)
    return cfg.num_layers * (value_bytes + 2 * 4 * hkv)


def with_kv_bits(model: Model, kv_bits: int) -> Model:
    """`model` with its KV cache stored at `kv_bits` (0: as it is), rebuilt
    on its own device: the cache layout follows the config, and the
    parameters do not depend on it."""
    if not kv_bits or kv_bits == model.cfg.kv_bits:
        return model
    return build_model(dataclasses.replace(model.cfg, kv_bits=int(kv_bits)),
                       model.device)


class SubmitError(ValueError):
    """Base of the typed `Scheduler.submit` rejections: the request can
    never be served."""


class EmptyPrompt(SubmitError):
    """Rejected: the prompt has no tokens."""


class InvalidBudget(SubmitError):
    """Rejected: `max_new_tokens` <= 0 (admission always samples one)."""


class PromptTooLong(SubmitError):
    """Rejected: the prompt reaches `max_len` or needs more pages than the
    pool owns; at the queue head it would wedge FCFS admission forever."""


class Overloaded(RuntimeError):
    """Back-pressure: the bounded admission queue (`max_queue`) is full.
    The caller sheds load or retries; `stats["rejections"]` counts it."""


class AuditError(AssertionError):
    """`Scheduler.audit()` found a broken invariant of the page accounting
    (slot rows, directory entries and victim records against the
    refcounts and the free list)."""


def _truncate_logits(l: torch.Tensor, top_k: int, top_p: float) -> torch.Tensor:
    """top_k / nucleus truncation of temperature-scaled float32 logits
    (masked entries -> -inf) over the last axis, any leading dims.

    top_k keeps the logits not below the k-th largest value (ties at it
    stay, as with `lax.top_k`'s k-th value).  Nucleus rule: keep the
    shortest descending-probability prefix whose exclusive cumulative
    mass is below top_p, in the order of a stable sort (ties keep the
    lower token id first, as the reference's stable `argsort(-probs)`);
    the boundary token is kept, so the set is never empty."""
    V = l.shape[-1]
    if top_k:
        k = min(int(top_k), V)
        if k < V:
            kth = torch.topk(l, k, dim=-1).values[..., -1:]
            l = torch.where(l < kth, float("-inf"), l)
    if top_p < 1.0:
        probs = torch.softmax(l, dim=-1)
        sp, order = torch.sort(probs, dim=-1, descending=True, stable=True)
        exclusive = blocked_cumsum(sp) - sp
        keep_sorted = exclusive < top_p
        keep_sorted[..., 0] = True
        keep = torch.empty_like(keep_sorted).scatter_(-1, order, keep_sorted)
        l = torch.where(keep, l, float("-inf"))
    return l


def sample_logits(logits: torch.Tensor, key: Optional[torch.Tensor],
                  temperature: float = 0.0, top_k: int = 0,
                  top_p: float = 1.0) -> torch.Tensor:
    """(B, V) logits -> (B,) token ids: greedy at temperature 0 (first
    maximum on ties; `key` may be None), else the reference's draw from
    the temperature-scaled, top_k / top_p truncated distribution with the
    one threefry `key` for the whole batch (`prng.categorical`)."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    l = _truncate_logits(logits.float() / temperature, top_k, top_p)
    return prng.categorical(key, l)


def _row_keys(base_key: torch.Tensor, rids, gens) -> torch.Tensor:
    """(B, 2) per-row sampling keys: (request id, generated-token index)
    folded into the scheduler's base key.  A request's i-th token samples
    with the same key whichever dispatch computes it (admission prefill,
    mixed step, decode chunk, or the re-prefill of an eviction
    continuation)."""
    return prng.fold_in(prng.fold_in(base_key, torch.clamp(rids, min=0)), gens)


def _row_key_grid(base_key: torch.Tensor, rids, gens, P: int) -> torch.Tensor:
    """(B, P, 2) keys: column j of row b is the `_row_keys` key of token
    index gens[b] + j, so the speculative verifier's column-j coin and
    resample use the key stream of the non-speculative scheduler."""
    col = torch.arange(P, device=gens.device, dtype=gens.dtype)
    kr = prng.fold_in(base_key, torch.clamp(rids, min=0))
    return prng.fold_in(kr[:, None, :], gens[:, None] + col[None, :])


def sample_logits_per_row(logits: torch.Tensor, keys, temperature: float = 0.0,
                          top_k: int = 0, top_p: float = 1.0) -> torch.Tensor:
    """`sample_logits` with its own key per batch row (keys: (B, 2) from
    `_row_keys`; ignored when greedy).  One call hashes the (B, V) noise
    grid of every row, where the reference vmaps a row at a time."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    l = _truncate_logits(logits.float() / temperature, top_k, top_p)
    return prng.categorical(keys, l)


class Sampling:
    """How the scheduler's device steps pick a row's token: greedy at
    temperature 0, else with the key of its (request id, token index)
    under the base `key` (`_row_keys`)."""

    def __init__(self, temperature: float, top_k: int, top_p: float,
                 key: torch.Tensor):
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.top_p = float(top_p)
        self.key = key

    @property
    def greedy(self) -> bool:
        return self.temperature <= 0.0

    def rows(self, logits: torch.Tensor, rids, gens) -> torch.Tensor:
        """(n, V) logits and (n,) device rids / gens -> (n,) tokens."""
        if self.greedy:
            return torch.argmax(logits, dim=-1)
        return sample_logits_per_row(
            logits, _row_keys(self.key, rids.long(), gens.long()),
            self.temperature, self.top_k, self.top_p)


def scheduler_supported(cfg: ModelConfig) -> bool:
    """The slot scheduler serves pure attention stacks: recurrent and ring
    states cannot be length-masked per slot, and encoder-decoder archs need
    per-request encoder features."""
    return (not cfg.is_encoder_decoder
            and set(cfg.block_pattern) <= {"attn", "moe"}
            and not cfg.window)


# ---------------------------------------------------------------------------
# the scheduler's device steps
# ---------------------------------------------------------------------------
def to_device(arrays, device) -> Tuple[torch.Tensor, ...]:
    """Host integer arrays -> int32 tensors on `device`, through one pinned
    buffer and one asynchronous copy (no stream synchronize): a step's
    tokens, offsets, lengths and page table reach the card together."""
    arrays = [np.ascontiguousarray(a, dtype=np.int32) for a in arrays]
    flat = torch.from_numpy(np.concatenate([a.reshape(-1) for a in arrays]))
    if torch.device(device).type == "cuda":
        flat = flat.pin_memory()
    flat = flat.to(device, non_blocking=True)
    out, i = [], 0
    for a in arrays:
        out.append(flat[i:i + a.size].view(a.shape))
        i += a.size
    return tuple(out)


def _poisoned(logits: torch.Tensor, poison) -> torch.Tensor:
    """NaN in the rows of `logits` that the (n,) device `poison` names (the
    fault plan's seam; elementwise, so every other row keeps its bits)."""
    if poison is None:
        return logits
    mask = poison.bool().view(-1, *([1] * (logits.dim() - 1)))
    return torch.where(mask, float("nan"), logits)


def _first_tokens(logits: torch.Tensor, sampling: Sampling, rids, gens,
                  poison=None):
    """The tokens of a prefill's (n, V) logits (`sampling`, with the rows'
    device rids / gens), -1 where a row's logits are not all finite, after
    NaN went into the rows that the device `poison` names; one
    device-to-host copy.  Returns host (tok0, fin)."""
    logits = _poisoned(logits, poison)
    fin = torch.isfinite(logits).all(dim=-1)
    tok = torch.where(fin, sampling.rows(logits, rids, gens), -1)
    out = torch.stack([tok, fin.long()]).cpu().numpy()
    return out[0].astype(np.int32), out[1].astype(bool)


def ragged_prefill(model: Model, params, toks: np.ndarray, lens: np.ndarray,
                   big_cache, slots: np.ndarray, *, rids: np.ndarray,
                   gens: np.ndarray, sampling: Sampling,
                   poison: Optional[np.ndarray] = None):
    """Admission prefill into dense slots: n left-aligned prompts padded to
    L ((n, L) tokens, (n,) valid lengths) run through one forward over an
    L-token sub-batch ragged cache (padding K/V is written but never
    advertised), whose rows are then copied into the first L positions of
    the big cache's `slots`.  Each row's first token is sampled from its
    last valid position with the key of its (rids, gens) entry; `poison`
    (n,) puts NaN into the named rows' logits.  Returns the host (first
    tokens, finite rows)."""
    n, L = toks.shape
    toks_d, lens_d, offs_d, slots_d, rids_d, gens_d, *pois = to_device(
        (toks, lens, np.zeros(n), slots, rids, gens)
        + (() if poison is None else (poison,)), model.device)
    sub = model.init_cache(n, L, ragged=True)
    logits, sub = model.forward_serve(params, {"tokens": toks_d}, sub,
                                      offs_d, seq_lens=lens_d)
    T.cache_scatter(big_cache, sub, slots_d.long())
    return _first_tokens(logits, sampling, rids_d, gens_d, *pois)


def paged_prefill(model: Model, params, toks: np.ndarray, lens: np.ndarray,
                  pool, pages: np.ndarray, offs: np.ndarray, *,
                  rids: np.ndarray, gens: np.ndarray, sampling: Sampling,
                  poison: Optional[np.ndarray] = None):
    """Admission prefill into the paged pool: the prompts write straight
    into their slots' pages (the (n, max_pages) rows of the page table), no
    sub-batch cache and no copy.  `offs` is each row's absolute position of
    its first token (0 without a prefix hit): after a hit a row's leading table
    entries already hold the shared prefix, and only its tail runs here,
    attending over the prefix through the table.  A chunk wave of mixed
    steps is the same call at the chunks' starts.  Sampling and `poison`
    as in `ragged_prefill`.  Returns the host (first tokens, finite
    rows)."""
    toks_d, lens_d, offs_d, pages_d, rids_d, gens_d, *pois = to_device(
        (toks, lens, offs, pages, rids, gens)
        + (() if poison is None else (poison,)), model.device)
    logits, _ = model.forward_serve(params, {"tokens": toks_d}, pool, offs_d,
                                    seq_lens=lens_d, pages=pages_d)
    return _first_tokens(logits, sampling, rids_d, gens_d, *pois)


def page_copy(model: Model, cache, pairs: Sequence[Tuple[int, int]]):
    """Copy-on-write device step: page src -> dst for every (src, dst) of
    `pairs`, in every layer's pool, in place (stream-ordered before the
    next forward, which reads the copies)."""
    src, dst = to_device(([s for s, _ in pairs], [d for _, d in pairs]),
                         model.device)
    return T.cache_copy_pages(cache, src, dst)


def _planes(tree) -> List[torch.Tensor]:
    """The planes of a `cache_fetch_pages` tree, in a fixed order."""
    return [x for k in sorted(tree) for pool in tree[k] if pool is not None
            for x in (pool.k_q, pool.v_q, pool.k_scale, pool.v_scale)]


def _moved(tree, device):
    """A copy of a page tree on `device`, in one transfer: the bytes of its
    planes packed into one buffer, each plane then a view of its stretch
    of the moved buffer.  The copy is synchronous and the host side
    pageable: a pinned buffer of a new size costs more to allocate (tens
    of ms on the card's host) than the copy itself."""
    planes = _planes(tree)
    flat = torch.cat([p.reshape(-1).view(torch.uint8) for p in planes])
    parts = flat.to(device).split([p.numel() * p.element_size() for p in planes])
    moved = iter([c.view(p.dtype).view(p.shape) for p, c in zip(planes, parts)])
    return {k: tuple(None if pool is None else A.PagedKVCache(
        *(next(moved) for _ in range(4))) for pool in tree[k])
        for k in sorted(tree)}


def page_fetch(model: Model, cache, pages: Sequence[int]):
    """Spill device step: gather `pages` out of every layer's pool and
    copy them to host memory in one transfer, which waits for the device.
    Returns the host tree (`cache_fetch_pages` structure); the gathered
    pages are new storage, so nothing of the pool survives in it."""
    pages_d, = to_device((np.asarray(pages),), model.device)
    return _moved(T.cache_fetch_pages(cache, pages_d.long()), "cpu")


def page_restore(model: Model, cache, pages: Sequence[int], data):
    """Restore device step: the host tree `data` to the device in one
    transfer, scattered into pool pages `pages` of every layer in place
    (stream-ordered before the next forward)."""
    pages_d, = to_device((np.asarray(pages),), model.device)
    return T.cache_restore_pages(cache, pages_d.long(),
                                 _moved(data, model.device))


def mixed_step(model: Model, params, toks: np.ndarray, cache,
               offs: np.ndarray, seq_lens: np.ndarray,
               decode_rows: np.ndarray, pages: Optional[np.ndarray], *,
               rids: np.ndarray, gens: np.ndarray, sampling: Sampling,
               poison: np.ndarray):
    """One mixed scheduler forward over a (B, L) rectangle: row b carries
    one decode token (`decode_rows[b]`, seq_lens 1 at its fill), a prefill
    chunk (seq_lens[b] prompt tokens at offset offs[b]) or nothing
    (seq_lens 0: no kernel work).  Attention sends each class through its
    separate dispatch's kernel (`blocks._mixed_attend`).  `poison` (B,)
    puts NaN into the named rows' logits.  Returns the host (token of
    every row at its last valid position, sampled with its (rids, gens)
    key, and finite rows); the caller keeps the decode rows' tokens and
    those of chunks that complete a prompt."""
    arrays = (toks, offs, seq_lens, decode_rows, rids, gens, poison) + (
        () if pages is None else (pages,))
    toks_d, offs_d, seq_d, dec_d, rids_d, gens_d, pois_d, *pt = to_device(
        arrays, model.device)
    logits, _ = model.forward_serve(
        params, {"tokens": toks_d}, cache, offs_d, seq_lens=seq_d,
        pages=pt[0] if pt else None, decode_rows=dec_d.bool())
    return _first_tokens(logits, sampling, rids_d, gens_d, pois_d)


def ragged_decode(model: Model, params, cache, tok, lengths, active,
                  remaining, chunk: int, eos_id: Optional[int], max_len: int,
                  pages: Optional[np.ndarray], *, rids: np.ndarray,
                  gens: np.ndarray, sampling: Sampling, poison: np.ndarray):
    """`chunk` decode steps for all slots, from host (B,) arrays.

    Every step writes each active slot's token at its own position, attends
    with per-slot lengths (idle slots run no KV partition), samples each
    row with the key of its (rids, gens) entry, gens advancing on the
    device while the row stays active, and retires rows that hit EOS,
    their budget or the cache capacity: a retired row's length drops to 0
    for the rest of the chunk.  `poison` (B,) puts NaN into the named
    rows' logits at the chunk's first step; a row whose logits are not all
    finite emits nothing, stops and is reported.  The lengths stay on the device
    between steps; the host reads the chunk once at its end.  Paged
    callers pass the (B, max_pages) page table, which must cover lengths +
    chunk tokens of every active slot.

    Returns host arrays (tok, lengths, active, remaining, toks (chunk, B),
    emitted (chunk, B) bool, poisoned (B,) bool)."""
    eos = -2 if eos_id is None else int(eos_id)      # -2 matches no token
    arrays = (tok, lengths, active, remaining, rids, gens, poison) + (
        () if pages is None else (pages,))
    tok, lengths, active, remaining, rids, gens, poison, *pt = to_device(
        arrays, model.device)
    pt = pt[0] if pt else None
    active = active.bool()
    pois = torch.zeros_like(active)
    toks, emitted = [], []
    V = model.cfg.vocab_size
    for t in range(chunk):
        act = active.int()
        # an idle row's token -1 embeds row V - 1, as the reference's
        # indexing takes it: a MoE step routes every row, idle ones too
        logits, cache = model.forward_serve(
            params, {"tokens": torch.where(tok < 0, tok + V, tok)[:, None]},
            cache, lengths, seq_lens=act, pages=pt)
        if t == 0:
            logits = _poisoned(logits, poison)
        fin = torch.isfinite(logits).all(dim=-1)
        live = active & fin
        nxt = torch.where(live, sampling.rows(logits, rids, gens).int(), -1)
        new_len = lengths + act
        new_active = live & (nxt != eos) & (remaining > 1) & (new_len < max_len)
        lengths = torch.where(active & ~new_active, 0, new_len)
        remaining = remaining - act
        gens = gens + act
        pois = pois | (active & ~fin)
        toks.append(nxt)
        emitted.append(live)
        tok, active = nxt, new_active
    out = torch.cat([torch.stack(toks), torch.stack(emitted).int(),
                     torch.stack([tok, lengths, active.int(), remaining,
                                  pois.int()])]).cpu().numpy()
    tok, lengths, active, remaining, pois = out[2 * chunk:]
    return (tok, lengths, active.astype(bool), remaining, out[:chunk],
            out[chunk:2 * chunk].astype(bool), pois.astype(bool))


def spec_accept(logits: torch.Tensor, toks: torch.Tensor, seq_lens, dec,
                rids, gens, sampling: Sampling):
    """The accept rule of `spec_step`, on the device: (n, P, V) logits, the
    step's (n, L >= P) tokens, (n,) seq_lens, decode-row mask, rids and
    gens -> ((n, P) tokens, (n,) accepted drafts acc); row b emits its
    first acc[b] + 1 tokens.

    Column j scores the token drafted at column j + 1.  Greedy: the
    longest prefix of drafts equal to the argmax chain, emitting
    argmax[0..acc].  Sampled: rejection sampling against the truncated
    distribution p; draft d_j survives with probability p_j(d_j) (coin
    `uniform(fold_in(key_j, 1))`), the first rejection resamples from p_j
    with d_j masked (`fold_in(key_j, 2)`), and a row whose drafts all
    survive draws a bonus token from its last column with key_j itself,
    so zero-draft rows and chunk rows reduce to the mixed-step sampler.
    Row b's key_j is the `_row_keys` key of token index gens[b] + j."""
    n, P = logits.shape[:2]
    col = torch.arange(P, device=seq_lens.device, dtype=seq_lens.dtype)
    drafts = toks[:, 1:P]                                # (n, P - 1)
    valid = dec[:, None] & (col[None, 1:] < seq_lens[:, None])
    if sampling.greedy:
        out = torch.argmax(logits, dim=-1).int()         # (n, P)
        match = (drafts == out[:, :P - 1]) & valid
        return out, torch.cumprod(match.int(), dim=-1).sum(dim=-1)
    keys = _row_key_grid(sampling.key, rids.long(), gens.long(), P)
    lt = _truncate_logits(logits.float() / sampling.temperature,
                          sampling.top_k, sampling.top_p)
    p = torch.softmax(lt, dim=-1)
    p_draft = torch.gather(p[:, :P - 1], -1, drafts.long()[..., None])[..., 0]
    u = prng.uniform(prng.fold_in(keys[:, :P - 1], 1))
    accept = valid & (u < p_draft)
    acc = torch.cumprod(accept.int(), dim=-1).sum(dim=-1)
    rows = torch.arange(n, device=acc.device)
    l_acc = lt[rows, acc]                                # (n, V)
    k_acc = keys[rows, acc]
    d_acc = toks[rows, torch.clamp(acc + 1, max=P - 1)].long()
    rejected = dec & (acc < seq_lens - 1)
    l_res = l_acc.scatter(-1, d_acc[:, None], float("-inf"))
    t_rej = prng.categorical(prng.fold_in(k_acc, 2), l_res)
    t_bonus = prng.categorical(k_acc, l_acc)
    t = torch.where(rejected, t_rej, t_bonus).int()
    shifted = torch.nn.functional.pad(drafts, (0, 1))
    return torch.where(col[None, :] < acc[:, None], shifted, t[:, None]), acc


def spec_step(model: Model, params, toks: np.ndarray, cache,
              offs: np.ndarray, seq_lens: np.ndarray, decode_rows: np.ndarray,
              verify_len: int, pages: Optional[np.ndarray], *,
              rids: np.ndarray, gens: np.ndarray, sampling: Sampling,
              poison: np.ndarray):
    """One speculative scheduler forward (the reference's
    `make_spec_step_fn`): decode rows carry their current token and up to
    `verify_len` - 1 drafted tokens (seq_lens 1 + k), chunk rows their
    chunk, idle rows nothing.  Every drafted position of a decode row runs
    through the split-K decode launch (`blocks._mixed_attend`), so each is
    scored as the single-token step it replaces, and the forward returns
    logits at all P = verify_len columns (`logit_positions`), which
    `spec_accept` turns into tokens.  KV of rejected drafts is written but
    never advertised.  `poison` (n,) puts NaN into every column of the
    named rows' logits.

    Returns host (out (n, P), n_emit (n,), fin (n,) bool): row b emits
    out[b, :n_emit[b]]."""
    n, P = toks.shape[0], int(verify_len)
    arrays = (toks, offs, seq_lens, decode_rows, rids, gens, poison) + (
        () if pages is None else (pages,))
    toks_d, offs_d, sl, dec_d, rids_d, gens_d, pois_d, *pt = to_device(
        arrays, model.device)
    dec = dec_d.bool()
    col = torch.arange(P, device=sl.device, dtype=sl.dtype)
    last = torch.clamp(sl, min=1) - 1
    pos = torch.where(dec[:, None], torch.minimum(col[None, :], last[:, None]),
                      last[:, None].expand(n, P))
    logits, _ = model.forward_serve(
        params, {"tokens": toks_d}, cache, offs_d, seq_lens=sl,
        pages=pt[0] if pt else None, decode_rows=dec, logit_positions=pos,
        verify_len=P)                                    # (n, P, V)
    logits = _poisoned(logits, pois_d)
    fin = torch.isfinite(logits).flatten(1).all(dim=-1)
    out, acc = spec_accept(logits, toks_d, sl, dec, rids_d, gens_d, sampling)
    res = torch.cat([out.int(), (acc + 1).int()[:, None],
                     fin.int()[:, None]], dim=1).cpu().numpy()
    return res[:, :P], res[:, P], res[:, P + 1].astype(bool)


def propose_draft_tokens(context: Sequence[int], k: int, *,
                         max_ngram: int = 3,
                         eos_id: Optional[int] = None) -> List[int]:
    """Self-speculative n-gram (prompt-lookup) draft proposer.

    Finds the rightmost earlier occurrence of the longest suffix n-gram
    (from `max_ngram` tokens down to 1) of `context`, the slot's own
    prompt + generated tokens, and proposes the tokens that followed it.
    When the match sits near the end (a tight cycle), the lookup runs
    again on context + draft so far, until `k` tokens are proposed or no
    suffix repeats.  Returns [] when nothing repeats.  A proposal is cut
    at the first EOS, inclusive.  Deterministic: a context always gives
    the same proposal."""
    ctx = [int(t) for t in context]
    if k <= 0 or len(ctx) < 2:
        return []
    out: List[int] = []
    while len(out) < k:
        ext = ctx + out
        n = len(ext)
        chunk: List[int] = []
        for g in range(min(int(max_ngram), n - 1), 0, -1):
            suffix = ext[n - g:]
            for i in range(n - g - 1, -1, -1):
                if ext[i:i + g] == suffix:
                    chunk = ext[i + g: i + g + (k - len(out))]
                    break
            if chunk:
                break
        if not chunk:
            break
        if eos_id is not None and int(eos_id) in chunk:
            out += chunk[: chunk.index(int(eos_id)) + 1]
            break
        out += chunk
    return out


# ---------------------------------------------------------------------------
# the scheduler
# ---------------------------------------------------------------------------
def plan_prefill_chunk(start: int, prompt_len: int, budget: int,
                       page_size: int = 0) -> int:
    """The end of the next prefill chunk of a prompt at progress `start`:
    at most `budget` tokens, never past `prompt_len`, and in paged mode cut
    back to a page boundary when the chunk does not finish the prompt and a
    boundary past `start` is in reach.  Always advances; the last chunk
    ends at `prompt_len`, so chunked admission computes every prompt token
    once."""
    if not 0 <= start < prompt_len:
        raise ValueError(f"start {start} outside [0, {prompt_len})")
    if budget < 1:
        raise ValueError(f"prefill chunk budget must be >= 1, got {budget}")
    end = min(prompt_len, start + budget)
    if page_size and end < prompt_len:
        aligned = (end // page_size) * page_size
        if aligned > start:
            end = aligned
    return end


DEFER = object()
"""Sentinel: admission must wait for a prefill in flight to publish its
prefix-directory entries (distinct from None, the pool is full)."""


class Request:
    """One generation request tracked by the Scheduler.  `deadline_ms` /
    `ttl_steps` bound its lifetime from submit, in milliseconds of the
    scheduler's clock or in scheduler steps: a request past either is shed
    from the queue, or retired from its slot with the tokens it has.
    `status` is "queued" -> "done" | "deadline_missed" | "poisoned"."""

    __slots__ = ("rid", "prompt", "max_new_tokens", "tokens", "done",
                 "deadline_ms", "ttl_steps", "submit_step", "submit_time",
                 "status", "spec_k")

    def __init__(self, rid: int, prompt: Sequence[int], max_new_tokens: int,
                 deadline_ms: Optional[float] = None,
                 ttl_steps: Optional[int] = None):
        self.rid = rid
        self.prompt = list(int(t) for t in prompt)
        self.max_new_tokens = int(max_new_tokens)
        self.tokens: List[int] = []
        self.done = False
        self.deadline_ms = None if deadline_ms is None else float(deadline_ms)
        self.ttl_steps = None if ttl_steps is None else int(ttl_steps)
        self.submit_step = 0
        self.submit_time = 0.0
        self.status = "queued"
        # adaptive draft length of speculation: on the request, so that it
        # survives eviction and re-admission; None until the first
        # speculative step seeds it with draft_len
        self.spec_k: Optional[int] = None


class _SpillRecord:
    """Victim-pool entry of one evicted slot: what rebuilds its page-table
    row bit for bit.  `logical` lists the slot's pages in logical order,
    each ("host", i), a private page whose bytes are page i of `data` (the
    device page was freed), or ("ref", p), a shared page left resident,
    on which the record keeps one refcount until the restore.  `data` is
    the host copy of a `page_fetch` of `width` pages (a power of two, the
    padding lanes `TRASH_PAGE`), `n_host` of them real.  `covered` and
    `cur_tok` are the slot's kv fill and next decode input.  `crcs` are
    the host pages' spill-time checksums (`integrity != "off"`, else
    None), verified before a restore serves the bytes."""

    __slots__ = ("logical", "n_host", "width", "data", "covered", "cur_tok",
                 "crcs")

    def __init__(self, logical, n_host, width, data, covered, cur_tok,
                 crcs=None):
        self.logical = logical
        self.n_host = int(n_host)
        self.width = int(width)
        self.data = data
        self.covered = int(covered)
        self.cur_tok = int(cur_tok)
        self.crcs = crcs


LADDER_RUNGS = ("disable_speculation", "shrink_prefill_chunk",
                "pause_admission")
"""The SLA degradation ladder, mildest rung first: under pressure (queue
depth p95 or p95 time between tokens over target) it sheds speculative,
then prefill, then admission load, and releases the rungs in reverse as
the pressure clears.  Rungs change scheduling only, never a stream."""


class Scheduler:
    """Continuous-batching request scheduler over a slot-based KV cache.

    The cache is `max_batch_slots` independent slots with per-slot lengths.
    `submit` queues requests; every `step`:

      1. admits queued requests into free slots, one bucketed ragged
         prefill per admission wave (FCFS: the queue head waits rather than
         being skipped);
      2. runs one `decode_chunk`-step decode over all slots (idle slots cost
         no kernel compute), or one mixed step while a prompt is being
         prefilled in chunks;
      3. retires slots whose sequence hit EOS, its budget or the capacity,
         freeing them for the next wave, and returns the new tokens by
         request id.

    **Paged mode** (`page_size > 0`): KV memory is a pool of `num_pages`
    pages (default: the dense footprint, + the trash page), and each slot
    holds a page-table row.  A request is admitted when a slot is free and
    the free pages cover its prompt; pages are allocated lazily as decode
    crosses page boundaries and return to the free list at retirement.
    When the pool cannot extend every active slot, the starved slots stall
    for the chunk (state untouched, no kernel compute); if no slot can run,
    the most recently admitted one is evicted, its pages freed and its
    request re-queued as a continuation (prompt + tokens so far), which
    under greedy decoding resumes the same stream on the behavioral path;
    on the kernel path the re-prefill runs the prefill kernel over tokens
    that the decode kernel produced, and the stream may part after it, as
    the reference's does (ROADMAP.md §3).

    **Prefix sharing** (`prefix_sharing=True`, paged only): every page has
    a refcount (slot table rows + directory entries hold it), and a prefix
    directory maps page-aligned token prefixes, and whole prompts of
    retired requests, to the pages holding their KV (LRU order).
    Admission maps a request's leading table entries onto its longest
    match and prefills only the tail (at least one token, which yields the
    first token's logits), at a per-row offset.  A write about to land in
    a page with refcount > 1 first copies it into a fresh page
    (copy-on-write); a page returns to the pool only when nobody holds it.
    Entries are LRU-evicted under pool pressure, and down to
    `prefix_cache_pages` distinct pages when that cap is set.

    **Mixed steps** (`mixed_steps=True`): an admitted request's slot enters
    a prefilling state, and while any slot is prefilling each step feeds
    the prefilling slots the next `plan_prefill_chunk` chunks of their
    prompts (`prefill_chunk_budget` tokens a step, FCFS in admission
    order) beside one decode token of every decoding slot.  `mixed_dispatch`
    "fused" runs both classes in one (B, L) forward; "paired" (paged only)
    runs a chunk wave of the prefilling rows, then the regular decode
    chunk.  A request whose prefix is still being prefilled waits for its
    registration.  Streams are identical with each option on or off.

    **Sampling** (`temperature > 0`, with `top_k` / `top_p`): a request's
    i-th token draws with the threefry key of (request id, i) under the
    base key `rng` (default `PRNGKey(0)`), whichever dispatch computes it,
    so sampled streams do not depend on batch composition, chunking,
    sharing, eviction or speculation.

    **Speculative decoding** (`speculate=True`): every step, each decoding
    slot's prompt + tokens is scanned by the n-gram proposer
    (`propose_draft_tokens`; `draft_mode="ngram"`) for up to `draft_len`
    drafts (the request's adaptive `spec_k`: + 1 after a step that
    accepts every draft, halved after one that accepts none), and its row
    carries [current token, drafts] as a verify row of 1 + k tokens; one
    forward scores every drafted position through the split-K decode
    kernel, bit-identical to the single-token steps it replaces.  The
    accepted prefix and a bonus or correction token are emitted (greedy:
    streams equal the non-speculative ones; sampled: rejection sampling
    on the same key stream).  Rejected drafts' KV is written but never
    advertised.  Paged allocation asks for each row's 1 + k writes
    without evicting, drops a starved row's drafts, and only then evicts.

    **Overload control.**  With `victim_pool_pages > 0` (paged only) an
    eviction spills the slot's private pages to host memory (one gather
    and one copy off the device) and keeps its shared pages resident under
    a refcount of its record; re-admission at the queue head restores the
    pages into fresh ones and resumes decoding, an O(pages) copy in place
    of the O(prompt + tokens) re-prefill, with the same stream.  A spill
    the pool's cap cannot take falls back to a recompute continuation.
    `max_queue` bounds the queue (`submit` raises `Overloaded`), and a
    request's `deadline_ms` (on `clock`) or `ttl_steps` sheds it from the
    queue or its slot.  `fault_plan` (`runtime/fault.py`) forces
    evictions, failed allocations, delayed restores, refcount corruptions
    that `audit()` must detect, and NaN logits that quarantine one request
    (`status="poisoned"`); `audit_every_step` (default: the `REPRO_AUDIT`
    environment variable) audits after every step.

    **4-bit KV** (`kv_bits=4`): the model is rebuilt around the precision
    (codes packed two a byte, f32 scales), so both attention kernels read
    4-bit pages and page, spill and restore bytes follow the stored width.

    **Integrity** (`integrity="checksum"`, paged only): a page's crc32 is
    recorded when the prefix directory first holds it (from then on
    copy-on-write keeps it immutable) and dropped with the last hold; a
    spill records its host pages' crcs, and a restore whose bytes no
    longer match falls back to recompute-from-prompt, so corrupt bytes are
    never served.  `"paranoid"` also verifies a prefix hit's pages before
    mapping them and an entry's pages at eviction, quarantining a corrupt
    prefix for good, and extends `audit()` to the victim pool's bytes.

    **SLA ladder** (`tbt_target_ms > 0`): when the p95 queue depth of the
    last 32 steps passes `queue_depth_target` (0: 2 * slots) or the p95
    time between steps on `clock` passes the target, it climbs one rung
    of `LADDER_RUNGS` per `ladder_cooldown_steps`: speculation off, the
    prefill chunk budget halved, admission paused (never while every slot
    is empty), and steps down as the pressure clears.

    **Snapshots** (`snapshot_dir`, every `snapshot_every` steps at the end
    of a step, or `snapshot()`): the pool's bytes, the sampling key and
    one pickled blob of every host structure (requests, queue, slots,
    pages, directory, crcs, victim records with their host bytes, ladder,
    fault state, counters) as a checkpoint generation.  `restore()` on a
    scheduler of the same configuration resumes every stream bit for bit;
    a fault plan's `crash_at_step` raises `CrashInjected` at the start of
    its step and never again after a restore."""

    def __init__(self, model: Model, params, *, max_batch_slots: int = 8,
                 max_len: int = 2048, eos_id: Optional[int] = None,
                 temperature: float = 0.0, top_k: int = 0, top_p: float = 1.0,
                 decode_chunk: int = 8, rng: Optional[torch.Tensor] = None,
                 prefill_bucket: int = 16,
                 page_size: int = 0, num_pages: int = 0,
                 prefix_sharing: bool = False, prefix_cache_pages: int = 0,
                 mixed_steps: bool = False, prefill_chunk_budget: int = 0,
                 mixed_dispatch: str = "fused", speculate: bool = False,
                 draft_len: int = 4, draft_mode: str = "ngram",
                 victim_pool_pages: int = 0, max_queue: int = 0,
                 fault_plan: Optional[FaultPlan] = None,
                 audit_every_step: Optional[bool] = None,
                 kv_bits: int = 0, integrity: str = "off",
                 tbt_target_ms: float = 0.0, queue_depth_target: int = 0,
                 ladder_cooldown_steps: int = 8, snapshot_every: int = 0,
                 snapshot_dir: Optional[str] = None,
                 clock: Callable[[], float] = time.monotonic):
        model = with_kv_bits(model, kv_bits)
        if not scheduler_supported(model.cfg):
            raise NotImplementedError(
                f"arch {model.cfg.name!r} is not supported by the slot "
                "scheduler (needs a pure attention stack, no windows, no "
                "encoder-decoder)")
        self.model = model
        self.params = params
        self.B = int(max_batch_slots)
        self.max_len = int(max_len)
        self.eos_id = eos_id
        self.decode_chunk = int(decode_chunk)
        self.prefill_bucket = int(prefill_bucket)
        key = prng.PRNGKey(0) if rng is None else torch.as_tensor(
            rng, dtype=torch.int64)
        self.sampling = Sampling(temperature, top_k, top_p,
                                 key.to(model.device))
        self.speculate = bool(speculate)
        self.draft_len = int(draft_len)
        self.draft_mode = str(draft_mode)
        if self.speculate:
            if self.draft_len < 1:
                raise ValueError(f"draft_len must be >= 1, got {draft_len}")
            if self.draft_mode != "ngram":
                raise ValueError(
                    f"unknown draft_mode {draft_mode!r} (only the "
                    "self-speculative 'ngram' proposer exists)")
        self.mixed_steps = bool(mixed_steps)
        self.prefill_chunk_budget = int(prefill_chunk_budget) or 32
        if self.mixed_steps and self.prefill_chunk_budget < 1:
            raise ValueError("prefill_chunk_budget must be >= 1")
        if mixed_dispatch not in ("fused", "paired"):
            raise ValueError(f"unknown mixed_dispatch {mixed_dispatch!r}")
        if mixed_dispatch == "paired" and not int(page_size) > 0:
            raise ValueError("mixed_dispatch='paired' requires page_size > 0 "
                             "(only page-table rows can be sub-batched)")
        self.mixed_dispatch = mixed_dispatch
        # a prefilling slot holds its pending tokens; `lengths` is its
        # progress.  _inflight_keys: slot -> the prefix keys it registers
        # when its prefill completes (admissions wanting one wait)
        self.prefilling = np.zeros(self.B, bool)
        self._pend: List[Optional[List[int]]] = [None] * self.B
        self._inflight_keys: Dict[int, set] = {}
        self.paged = int(page_size) > 0
        if self.paged:
            self.page_size = int(page_size)
            self.max_pages = self._pages_for(self.max_len)
            self.num_pages = int(num_pages) or self.B * self.max_pages + 1
            if self.num_pages - 1 < self.max_pages:
                raise ValueError(
                    f"num_pages={self.num_pages} cannot hold one full-length "
                    f"sequence ({self.max_pages} pages + 1 reserved)")
            self.free_pages: List[int] = list(range(1, self.num_pages))
            self.page_table = np.full((self.B, self.max_pages), -1, np.int32)
            # holders of a page: slot table rows and directory entries
            self.page_ref = np.zeros(self.num_pages, np.int32)
            self.peak_pages_in_use = 0
            self.cache = model.init_cache(
                self.B, self.max_len, page_size=self.page_size,
                num_pages=self.num_pages)
        else:
            self.cache = model.init_cache(self.B, self.max_len, ragged=True)
        self.prefix_sharing = bool(prefix_sharing)
        if self.prefix_sharing and not self.paged:
            raise ValueError("prefix_sharing requires page_size > 0")
        self.prefix_cache_pages = int(prefix_cache_pages)
        # serialized token prefix -> (pages, tokens covered), in LRU order
        self.prefix_dir: "collections.OrderedDict[bytes, Tuple[Tuple[int, ...], int]]" = \
            collections.OrderedDict()
        self._dir_ref: Dict[int, int] = {}    # page -> directory holds
        self._last_keys: list = []            # the candidate's keys
        self.prefix_hits = 0                  # admissions that mapped pages
        self.prefix_hit_tokens = 0            # prefill tokens skipped
        self.prefill_tokens_computed = 0      # prefill tokens run
        self.n_cow_copies = 0                 # copy-on-write page copies
        self.prefix_evictions = 0             # directory entries evicted
        self.n_reclaim_stalls = 0             # reclaims that freed nothing
        self.lengths = np.zeros(self.B, np.int32)      # per-slot kv fill
        self.active = np.zeros(self.B, bool)
        self.remaining = np.zeros(self.B, np.int32)    # token budget left
        self.cur_tok = np.full(self.B, -1, np.int32)   # next decode input
        self.slot_req: List[Optional[Request]] = [None] * self.B
        self.queue: "collections.deque[Request]" = collections.deque()
        self.requests: Dict[int, Request] = {}
        self._next_rid = 0
        # admission stamps: chunks go FCFS, the youngest slot is the
        # eviction victim
        self._admit_seq = np.zeros(self.B, np.int64)
        self._admit_counter = 0
        self._step_idx = 0
        self._queue_depths: List[int] = []
        self.model_steps = 0         # device forwards (a chunk counts each)
        self.n_evictions = 0
        self.n_poisoned = 0
        self.n_spec_steps = 0        # speculative forwards
        self.spec_proposed = 0       # draft tokens sent to verification
        self.spec_accepted = 0
        self.spec_rejected = 0
        # overload control: victim pool, bounded queue, deadlines, faults
        self.victim_pool_pages = int(victim_pool_pages)
        if self.victim_pool_pages and not self.paged:
            raise ValueError("victim_pool_pages requires page_size > 0 "
                             "(only paged KV can spill page-granularly)")
        self.max_queue = int(max_queue)
        self._clock = clock
        self._faults = fault_plan.start() if fault_plan is not None else None
        if audit_every_step is None:
            audit_every_step = bool(int(os.environ.get("REPRO_AUDIT", "0")))
        self._audit_every = bool(audit_every_step)
        # rid -> record of a spilled continuation (queued like any other)
        self._victim: Dict[int, _SpillRecord] = {}
        self._victim_used = 0                 # host pages the records hold
        self._page_bytes = (self.page_size * kv_bytes_per_token(model.cfg)
                            if self.paged else 0)
        self._poison_mask = np.zeros(self.B, bool)
        self.n_spills = 0                     # evictions spilled to host
        self.n_restores = 0                   # spilled slots re-admitted
        self.spilled_pages = 0                # pages copied off the device
        self.spill_bytes = 0                  # their bytes (_page_bytes each)
        self.n_recompute_fallbacks = 0        # spills the cap refused
        self.n_deadline_misses = 0
        self.n_rejections = 0                 # submits refused (Overloaded)
        self.refcount_corruptions_detected = 0
        # integrity: write- and spill-time page checksums, quarantine
        if integrity not in ("off", "checksum", "paranoid"):
            raise ValueError(f"unknown integrity mode {integrity!r} "
                             "(off | checksum | paranoid)")
        if integrity != "off" and not self.paged:
            raise ValueError("integrity checksums are page-granular: they "
                             "require page_size > 0")
        self.integrity = str(integrity)
        # page -> crc32 when the directory first held it; its keys are
        # always directory-held pages (slot-private pages are mutable)
        self.page_crc: Dict[int, int] = {}
        self.quarantined: set = set()         # prefix keys barred for good
        self.corruptions_detected = 0
        self.bitflips_injected = 0
        # the SLA degradation ladder
        self.tbt_target_ms = float(tbt_target_ms)
        self.queue_depth_target = int(queue_depth_target) or 2 * self.B
        self.ladder_cooldown_steps = max(1, int(ladder_cooldown_steps))
        self.ladder_level = 0
        self.ladder_escalations = 0
        self.ladder_deescalations = 0
        self.ladder_paused_steps = 0
        self.ladder_transitions = {r: 0 for r in LADDER_RUNGS}
        self._ladder_last_change = 0
        self._tbt_samples: "collections.deque[float]" = \
            collections.deque(maxlen=32)
        self._last_step_time: Optional[float] = None
        # snapshots
        self.snapshot_every = int(snapshot_every)
        self.snapshot_dir = snapshot_dir
        if self.snapshot_every and not self.snapshot_dir:
            raise ValueError("snapshot_every requires snapshot_dir")
        self.n_snapshots = 0

    # -- request intake -----------------------------------------------------
    def submit(self, prompt: Sequence[int], max_new_tokens: int,
               deadline_ms: Optional[float] = None,
               ttl_steps: Optional[int] = None) -> int:
        """Queue a request; raises a `SubmitError` for one that can never
        be served, and `Overloaded` when the bounded queue is full."""
        prompt = list(prompt)
        if not prompt:
            raise EmptyPrompt("empty prompt: nothing to condition on")
        if int(max_new_tokens) <= 0:
            raise InvalidBudget(
                f"max_new_tokens must be >= 1, got {max_new_tokens}")
        if len(prompt) >= self.max_len:
            raise PromptTooLong(
                f"prompt length {len(prompt)} >= max_len {self.max_len} "
                "(no room for even one generated token)")
        if self.paged and self._pages_for(len(prompt) + 1) > self.num_pages - 1:
            raise PromptTooLong(
                f"prompt needs {self._pages_for(len(prompt) + 1)} pages; the "
                f"pool only has {self.num_pages - 1}")
        if self.max_queue and len(self.queue) >= self.max_queue:
            self.n_rejections += 1
            raise Overloaded(
                f"admission queue full ({self.max_queue} requests)")
        r = Request(self._next_rid, prompt, max_new_tokens,
                    deadline_ms=deadline_ms, ttl_steps=ttl_steps)
        r.submit_step = self._step_idx
        r.submit_time = self._clock()
        self._next_rid += 1
        self.requests[r.rid] = r
        self.queue.append(r)
        return r.rid

    def _is_stale(self, r: Request) -> bool:
        if (r.ttl_steps is not None
                and self._step_idx - r.submit_step > r.ttl_steps):
            return True
        return (r.deadline_ms is not None
                and (self._clock() - r.submit_time) * 1e3 > r.deadline_ms)

    def _shed_stale(self):
        """Drop queued requests past their deadline or ttl; a shed spilled
        continuation releases its victim record."""
        kept: "collections.deque[Request]" = collections.deque()
        while self.queue:
            r = self.queue.popleft()
            if self._is_stale(r):
                r.done = True
                r.status = "deadline_missed"
                self.n_deadline_misses += 1
                self._drop_victim(r.rid)
            else:
                kept.append(r)
        self.queue = kept

    def _shed_admitted(self):
        """Retire admitted (decoding or prefilling) requests past their
        deadline or ttl, with the tokens they have; their pages are freed
        and nothing is registered."""
        for b in range(self.B):
            r = self.slot_req[b]
            if r is not None and self._is_stale(r):
                self.n_deadline_misses += 1
                self._retire(b, status="deadline_missed", register=False)

    def _bucket(self, n: int) -> int:
        b = self.prefill_bucket
        while b < n:
            b *= 2
        # never a prefill wider than the cache
        return min(b, self.max_len)

    # -- page allocator (host side; pages are opaque to the device) --------
    def _pages_for(self, tokens: int) -> int:
        return -(-int(tokens) // self.page_size)

    def _alloc_slot(self, slot: int, tokens: int) -> bool:
        """Grow `slot`'s page-table row to cover `tokens` tokens (capped at
        max_len), all or nothing; a shortage first reclaims directory
        entries."""
        need = self._pages_for(min(int(tokens), self.max_len))
        row = self.page_table[slot]
        have = int((row >= 0).sum())
        if need <= have:
            return True
        # a planned failure is asked only when pages would really be taken
        if self._faults is not None and self._faults.fail_alloc(self._step_idx):
            return False
        if need - have > len(self.free_pages):
            self._reclaim(need - have)
            if need - have > len(self.free_pages):
                return False
        for j in range(have, need):
            p = self.free_pages.pop()
            self.page_ref[p] = 1
            row[j] = p
        return True

    def _free_slot_pages(self, slot: int):
        """Drop the slot's hold on its pages; a page nobody else holds (no
        slot, no directory entry) returns to the pool."""
        row = self.page_table[slot]
        for p in row[row >= 0]:
            p = int(p)
            self.page_ref[p] -= 1
            if self.page_ref[p] == 0:
                self.free_pages.append(p)
        row[:] = -1

    def pages_in_use(self) -> int:
        """Allocated (non-free, non-trash) pages right now; a shared page
        counts once."""
        return (self.num_pages - 1) - len(self.free_pages)

    def _note_peak(self):
        if self.paged:
            self.peak_pages_in_use = max(self.peak_pages_in_use,
                                         self.pages_in_use())

    # -- prefix directory (host metadata) -----------------------------------
    @staticmethod
    def _prefix_key(tokens: Sequence[int]) -> bytes:
        return np.asarray(tokens, np.int32).tobytes()

    def directory_pages(self) -> int:
        """Distinct pages the directory holds."""
        return len(self._dir_ref)

    def _dir_put(self, key: bytes, pages: Sequence[int], covered: int):
        if key in self.quarantined:
            # a corrupt prefix never re-enters: later prompts recompute it
            return
        if key in self.prefix_dir:
            self.prefix_dir.move_to_end(key)
            return
        # the pages are immutable from now on (copy-on-write): their crcs
        # now are what every later verification compares against
        self._record_page_crcs(pages)
        for p in pages:
            self.page_ref[p] += 1
            self._dir_ref[p] = self._dir_ref.get(p, 0) + 1
        self.prefix_dir[key] = (tuple(int(p) for p in pages), int(covered))
        if self.prefix_cache_pages:
            while (len(self._dir_ref) > self.prefix_cache_pages
                   and self.prefix_dir):
                self._dir_evict_one()

    def _dir_evict_one(self, key: Optional[bytes] = None,
                       verify: bool = True):
        if key is None:
            key, (pages, _) = self.prefix_dir.popitem(last=False)   # LRU
        else:
            pages, _ = self.prefix_dir.pop(key)
        if verify and self.integrity == "paranoid":
            bad = self._verify_pages(pages)
            if bad:
                self.corruptions_detected += bad
                self.quarantined.add(key)
        for p in pages:
            self.page_ref[p] -= 1
            self._dir_ref[p] -= 1
            if self._dir_ref[p] == 0:
                del self._dir_ref[p]
                self.page_crc.pop(p, None)
            if self.page_ref[p] == 0:
                self.free_pages.append(p)
        self.prefix_evictions += 1

    def _quarantine_entry(self, key: bytes):
        """Bar `key` from the directory for good, evicting its entry: later
        prompts with this prefix recompute their KV."""
        self.quarantined.add(key)
        if key in self.prefix_dir:
            self._dir_evict_one(key, verify=False)

    # -- page checksums (integrity != "off"; crc32 on the host) -------------
    def _compute_page_crcs(self, pages: Sequence[int]) -> List[int]:
        """The crc32 of each listed page's bytes in every layer now."""
        return [int(c) for c in T.cache_page_checksums(self.cache, list(pages))]

    def _record_page_crcs(self, pages: Sequence[int]):
        if self.integrity == "off":
            return
        new = [int(p) for p in pages if int(p) not in self.page_crc]
        if new:
            self.page_crc.update(zip(new, self._compute_page_crcs(new)))

    def _verify_pages(self, pages: Sequence[int]) -> int:
        """How many listed pages no longer match their recorded crc (pages
        without one, never directory-held, are skipped)."""
        if self.integrity == "off":
            return 0
        known = [int(p) for p in pages if int(p) in self.page_crc]
        if not known:
            return 0
        return sum(1 for p, c in zip(known, self._compute_page_crcs(known))
                   if c != self.page_crc[p])

    @staticmethod
    def _victim_mismatches(rec: _SpillRecord) -> int:
        """How many of a spill record's host pages no longer match their
        spill-time crcs (0 for a record without crcs)."""
        if rec.crcs is None or not rec.n_host:
            return 0
        crcs = T.cache_page_checksums(rec.data, list(range(rec.n_host)))
        return sum(1 for a, b in zip(crcs, rec.crcs) if int(a) != int(b))

    def _verify_victim(self, rec: _SpillRecord) -> bool:
        """Checksum a spill record's host pages, counting mismatches; False
        means the bytes must not be restored (the request recomputes from
        its prompt)."""
        if self.integrity == "off":
            return True
        bad = self._victim_mismatches(rec)
        self.corruptions_detected += bad
        return bad == 0

    def _reclaim(self, need: int):
        """Evict directory entries, LRU first, until `need` pages are free.
        Only an entry holding a page of which it is the last holder frees
        anything; when none is left the reclaim stops (a stall) instead of
        churning the directory."""
        while len(self.free_pages) < need:
            victim = None
            for key, (pages, _) in self.prefix_dir.items():   # LRU order
                if any(self.page_ref[p] == 1 for p in pages):
                    victim = key
                    break
            if victim is None:
                if self.prefix_dir:
                    self.n_reclaim_stalls += 1
                break
            self._dir_evict_one(victim)

    def clear_prefix_cache(self):
        """Drop every directory entry (pages no slot holds return to the
        pool)."""
        while self.prefix_dir:
            self._dir_evict_one()

    def _lookup_prefix(self, prompt: Sequence[int]):
        """The longest directory match of `prompt`: the exact prompt first
        (a retired request's entry covers its partial last page too), then
        page-aligned prefixes, longest first.  Returns (pages, covered) or
        (None, 0); a match moves to the MRU end.  Under paranoid integrity
        a hit's pages are checksummed before they are mapped."""
        buf = self._prefix_key(prompt)
        hit = self.prefix_dir.get(buf)
        if (hit is not None and hit[1] == len(prompt)
                and not self._paranoid_hit_bad(buf, hit)):
            self.prefix_dir.move_to_end(buf)
            return hit
        for k in range(len(prompt) // self.page_size, 0, -1):
            key = buf[: 4 * k * self.page_size]
            hit = self.prefix_dir.get(key)
            if (hit is not None and hit[1] == k * self.page_size
                    and not self._paranoid_hit_bad(key, hit)):
                self.prefix_dir.move_to_end(key)
                return hit
        return None, 0

    def _paranoid_hit_bad(self, key: bytes, hit) -> bool:
        """Paranoid integrity: a hit whose pages fail their crcs is
        quarantined and never served (the walk tries shorter prefixes)."""
        if self.integrity != "paranoid":
            return False
        bad = self._verify_pages(hit[0])
        if bad:
            self.corruptions_detected += bad
            self._quarantine_entry(key)
        return bad > 0

    def _registration_keys(self, prompt: Sequence[int], exact: bool):
        """[(key, pages, tokens covered)] that `_register_prefixes` inserts
        for `prompt`: each page-aligned prefix and, with `exact`, the whole
        prompt (its partial last page included).  Key k is the first
        4 * k * page_size bytes of the int32 prompt."""
        ps = self.page_size
        buf = self._prefix_key(prompt)
        keys = [(buf[: 4 * k * ps], k, k * ps)
                for k in range(1, len(prompt) // ps + 1)]
        if exact and len(prompt) % ps:
            keys.append((buf, self._pages_for(len(prompt)), len(prompt)))
        return keys

    def _register_prefixes(self, slot: int, prompt: Sequence[int],
                           exact: bool):
        """Publish `slot`'s prompt KV once no write can land in the covered
        pages any more: the page-aligned prefixes after the prefill, the
        whole prompt at retirement."""
        row = self.page_table[slot]
        for key, n_pages, covered in self._registration_keys(prompt, exact):
            self._dir_put(key, [int(p) for p in row[:n_pages]], covered)

    # -- copy-on-write ------------------------------------------------------
    def _cow_range(self, slot: int, start: int, end: int,
                   pairs: List[Tuple[int, int]]) -> bool:
        """Privatize `slot`'s pages in the write range [start, end): a page
        there with refcount > 1 gets a fresh page ((src, dst) appended to
        `pairs`) and the table entry moves to it.  False when no fresh page
        can be found even after a reclaim (entries already moved stay
        moved; their copies must still run)."""
        if start >= end:
            return True
        row = self.page_table[slot]
        ps = self.page_size
        for j in range(start // ps, (end - 1) // ps + 1):
            p = int(row[j])
            if p < 0 or self.page_ref[p] <= 1:
                continue
            if not self.free_pages:
                self._reclaim(1)
                if not self.free_pages:
                    return False
            fresh = self.free_pages.pop()
            self.page_ref[fresh] = 1
            self.page_ref[p] -= 1        # the shared original never reaches 0
            row[j] = fresh
            pairs.append((p, fresh))
            self.n_cow_copies += 1
        return True

    def _apply_copies(self, pairs: List[Tuple[int, int]]):
        """Run the collected copy-on-write copies on the device, before the
        forward that reads or writes the fresh pages."""
        if pairs:
            page_copy(self.model, self.cache, pairs)

    # -- slot lifecycle -----------------------------------------------------
    def _eviction_victim(self) -> int:
        """The youngest active slot; ties break on the highest request id,
        so eviction is deterministic."""
        slots = np.flatnonzero(self.active)
        return int(max(slots, key=lambda b: (int(self._admit_seq[b]),
                                             self.slot_req[b].rid)))

    def _evict(self, slot: int):
        """Free a starved slot and re-queue its request at the head as a
        continuation.  With a victim pool the slot's KV is spilled first
        and re-admission restores it, bit for bit; otherwise (or when the
        pool's cap refuses it) re-admission prefills prompt + tokens so
        far.  Sampling keys are per (request, token index), so neither
        changes a draw's key.  Pages that other slots or the directory
        hold only lose this slot's hold."""
        r = self.slot_req[slot]
        spilled = False
        if (r is not None and self.victim_pool_pages
                and not self.prefilling[slot] and self.lengths[slot] > 0):
            spilled = self._spill(slot, r)
        self.slot_req[slot] = None
        self.active[slot] = False
        self.lengths[slot] = 0
        self.cur_tok[slot] = -1
        self.prefilling[slot] = False
        self._pend[slot] = None
        self._poison_mask[slot] = False
        self._inflight_keys.pop(slot, None)
        if self.paged and not spilled:
            self._free_slot_pages(slot)
        self.n_evictions += 1
        if r is not None:
            self.queue.appendleft(r)

    def _spill(self, slot: int, r: Request) -> bool:
        """Move `slot`'s KV into the victim pool: its private pages (this
        slot their only holder) are fetched in one power-of-two-padded
        gather, copied to host memory and freed; its shared pages stay
        resident, the record taking over the slot's hold.  False (a
        recompute continuation) when the cap cannot take the private
        pages."""
        row = self.page_table[slot]
        alloc = [int(p) for p in row[row >= 0]]
        private = [p for p in alloc if self.page_ref[p] == 1]
        n = len(private)
        if self._victim_used + n > self.victim_pool_pages:
            self.n_recompute_fallbacks += 1
            return False
        width = 1
        while width < max(n, 1):
            width *= 2
        data = crcs = None
        if n:
            data = page_fetch(self.model, self.cache,
                              private + [TRASH_PAGE] * (width - n))
            if self.integrity != "off":
                # checksums of the host copy, verified before a restore
                crcs = tuple(int(c) for c in T.cache_page_checksums(
                    data, list(range(n))))
        host_idx = {p: i for i, p in enumerate(private)}
        logical: List[Tuple[str, int]] = []
        for p in alloc:
            if self.page_ref[p] == 1:
                logical.append(("host", host_idx[p]))
                self.page_ref[p] = 0
                self.free_pages.append(p)
            else:
                # the record replaces the slot as a holder: net refcount
                # unchanged
                logical.append(("ref", p))
        row[:] = -1
        self._victim[r.rid] = _SpillRecord(
            logical, n, width, data, int(self.lengths[slot]),
            int(self.cur_tok[slot]), crcs)
        self._victim_used += n
        self.n_spills += 1
        self.spilled_pages += n
        self.spill_bytes += n * self._page_bytes
        return True

    def _restore(self, slot: int, r: Request, rec: _SpillRecord) -> bool:
        """Re-admit a spilled continuation into `slot`: its host pages go
        into fresh pages (one transfer and one scatter, padded as the
        fetch was), its shared entries are mapped again (the record's hold
        passes back to the slot), and the slot resumes decoding where the
        eviction stopped, with no prefill.  False when the pool cannot
        supply the fresh pages yet (the request stays at the head)."""
        n = rec.n_host
        if n > len(self.free_pages):
            self._reclaim(n)
            if n > len(self.free_pages):
                return False
        fresh = [self.free_pages.pop() for _ in range(n)]
        for p in fresh:
            self.page_ref[p] = 1
        row = self.page_table[slot]
        for j, (kind, val) in enumerate(rec.logical):
            row[j] = fresh[val] if kind == "host" else val
        if n:
            page_restore(self.model, self.cache,
                         fresh + [TRASH_PAGE] * (rec.width - n), rec.data)
        del self._victim[r.rid]
        self._victim_used -= n
        self.slot_req[slot] = r
        self.lengths[slot] = rec.covered
        self.cur_tok[slot] = rec.cur_tok
        self.remaining[slot] = r.max_new_tokens - len(r.tokens)
        self.active[slot] = True
        self.prefilling[slot] = False
        self._admit_counter += 1
        self._admit_seq[slot] = self._admit_counter
        self.n_restores += 1
        self._note_peak()
        return True

    def _drop_victim(self, rid: int):
        """Release a victim record without restoring it (its request was
        shed): the host pages are forgotten and its holds on resident
        shared pages dropped."""
        rec = self._victim.pop(rid, None)
        if rec is None:
            return
        self._victim_used -= rec.n_host
        for kind, p in rec.logical:
            if kind == "ref":
                self.page_ref[p] -= 1
                if self.page_ref[p] == 0:
                    self.free_pages.append(p)

    def _retire(self, slot: int, status: str = "done",
                register: bool = True):
        """Vacate `slot`.  With prefix sharing a finished request's whole
        prompt stays in the directory (`register`; never for a poisoned
        one): its rows past the prompt are never advertised, since a later
        hit re-runs the last prompt token through a copy of the page."""
        r = self.slot_req[slot]
        if r is not None:
            r.done = True
            r.status = status
        self.slot_req[slot] = None
        self.active[slot] = False
        self.lengths[slot] = 0
        self.prefilling[slot] = False
        self._pend[slot] = None
        self._poison_mask[slot] = False
        self._inflight_keys.pop(slot, None)
        if self.paged:
            if self.prefix_sharing and r is not None and register:
                self._register_prefixes(slot, r.prompt, exact=True)
            self._free_slot_pages(slot)

    def _try_admit_paged(self, slot: int, r: Request, pending_keys,
                         cow_pairs: List[Tuple[int, int]]):
        """Place `r` into `slot` (paged): map its directory match (with
        sharing), copy-on-write the tail's write range and allocate the
        rest.  Returns the tail offset (prompt tokens whose prefill is
        skipped; 0 without a hit), None when the pool cannot hold it, or
        DEFER when a prefill in flight is about to register one of its
        prefixes (a later wave maps them instead of duplicating them)."""
        pend = r.prompt + r.tokens
        p_len = len(pend)
        if self.prefix_sharing:
            keys = self._registration_keys(pend, True)
            if any(key in pending_keys for key, _, _ in keys):
                return DEFER
            self._last_keys = keys
            pages, covered = self._lookup_prefix(pend)
            if pages:
                # at least one tail token, whose logits give the first token
                tail_start = min(covered, p_len - 1)
                row = self.page_table[slot]
                for j, p in enumerate(pages):
                    row[j] = p
                    self.page_ref[p] += 1
                if (self._cow_range(slot, tail_start, p_len, cow_pairs)
                        and self._alloc_slot(slot, p_len)):
                    self.prefix_hits += 1
                    self.prefix_hit_tokens += tail_start
                    return tail_start
                # roll back, and drop copies into pages just freed again
                self._free_slot_pages(slot)
                cow_pairs[:] = [pr for pr in cow_pairs
                                if self.page_ref[pr[1]] > 0]
                return None
        return 0 if self._alloc_slot(slot, p_len) else None

    def _admit(self, emitted: Dict[int, List[int]]):
        # a wave that ends on DEFER registers its prefixes at once, so a
        # follow-up wave in the same step can map them (not in mixed mode,
        # where registration waits for the chunked prefill to complete)
        while self._admit_wave(emitted):
            pass

    def _admit_wave(self, emitted: Dict[int, List[int]]) -> bool:
        """One admission wave: place queued requests into free slots (in
        paged mode only while the free pages cover each prompt), then
        prefill them together and sample their first tokens, or (mixed
        steps) put them in the prefilling state.  Returns True when a
        follow-up wave should run now."""
        free = [i for i in range(self.B) if self.slot_req[i] is None]
        wave: List[Tuple[int, Request]] = []
        offs: List[int] = []
        cow_pairs: List[Tuple[int, int]] = []
        pending_keys: set = (set().union(*self._inflight_keys.values())
                             if self._inflight_keys else set())
        deferred = False
        while free and self.queue:
            rec = self._victim.get(self.queue[0].rid)
            if rec is not None and not self._verify_victim(rec):
                # the host bytes changed since the spill: drop the record
                # and recompute from the prompt; they never reach the pool
                self._drop_victim(self.queue[0].rid)
                self.n_recompute_fallbacks += 1
                rec = None
            if rec is not None:
                # a spilled continuation at the head is restored, not
                # prefilled: it decodes at once, outside the wave
                if (self._faults is not None
                        and self._faults.delay_restore(self._step_idx)):
                    break
                if not self._restore(free[0], self.queue[0], rec):
                    break                       # FCFS: wait for pages
                free.pop(0)
                self.queue.popleft()
                continue
            if self.paged:
                t = self._try_admit_paged(free[0], self.queue[0],
                                          pending_keys, cow_pairs)
                if t is DEFER:
                    deferred = True
                    break
                if t is None:
                    break                       # FCFS: no skipping ahead
                offs.append(t)
                if self.prefix_sharing:
                    pending_keys.update(k for k, _, _ in self._last_keys)
            else:
                offs.append(0)
            wave.append((free.pop(0), self.queue.popleft()))
        if not wave:
            return False
        if self.paged:
            # the copies land before any forward reads the fresh pages; the
            # peak is sampled while the wave's prompt pages are held
            self._apply_copies(cow_pairs)
            self._note_peak()
        if self.mixed_steps:
            for (s, r), off in zip(wave, offs):
                pend = r.prompt + r.tokens
                self.slot_req[s] = r
                self.prefilling[s] = True
                self._pend[s] = pend
                self.lengths[s] = off        # a prefix hit's KV is valid
                self.cur_tok[s] = -1
                self.active[s] = False
                self._admit_counter += 1
                self._admit_seq[s] = self._admit_counter
                if self.paged and self.prefix_sharing:
                    self._inflight_keys[s] = {
                        k for k, _, _ in self._registration_keys(pend, True)}
            # a deferral resolves only when a chunked prefill completes
            return False
        prompts = [r.prompt + r.tokens for _, r in wave]
        full_lens = np.array([len(p) for p in prompts], np.int32)
        offs_a = np.array(offs, np.int32)
        lens = full_lens - offs_a              # only the tails run
        toks = np.zeros((len(wave), self._bucket(int(lens.max()))), np.int32)
        for i, (p, o) in enumerate(zip(prompts, offs)):
            toks[i, :len(p) - o] = p[o:]
        slots = np.array([s for s, _ in wave], np.int32)
        ids = dict(rids=np.array([r.rid for _, r in wave], np.int32),
                   gens=np.array([len(r.tokens) for _, r in wave], np.int32),
                   sampling=self.sampling, poison=self._poison_mask[slots])
        self.prefill_tokens_computed += int(lens.sum())
        self.model_steps += 1
        if self.paged:
            tok0, fin = paged_prefill(self.model, self.params, toks, lens,
                                      self.cache, self.page_table[slots],
                                      offs_a, **ids)
            if self.prefix_sharing:
                # the prompts' KV is valid: publish the page-aligned
                # prefixes of every finite row
                for i, ((s, _), p) in enumerate(zip(wave, prompts)):
                    if fin[i]:
                        self._register_prefixes(s, p, exact=False)
        else:
            tok0, fin = ragged_prefill(self.model, self.params, toks, lens,
                                       self.cache, slots, **ids)
        for i, (s, r) in enumerate(wave):
            self.slot_req[s] = r
            self._admit_counter += 1
            self._admit_seq[s] = self._admit_counter
            self.lengths[s] = full_lens[i]
            if not fin[i]:
                # non-finite prompt logits: quarantine just this request
                self.n_poisoned += 1
                self._retire(s, status="poisoned", register=False)
                continue
            t0 = int(tok0[i])
            budget_left = r.max_new_tokens - len(r.tokens)
            r.tokens.append(t0)
            emitted.setdefault(r.rid, []).append(t0)
            self.cur_tok[s] = t0
            self.remaining[s] = budget_left - 1
            # capacity counts as done: a continuation re-admitted at max_len
            # tokens just produced its last in-capacity token
            if ((self.eos_id is not None and t0 == self.eos_id)
                    or budget_left <= 1 or int(full_lens[i]) >= self.max_len):
                self._retire(s)
            else:
                self.active[s] = True
        return deferred

    def _plan_decode_run(self, ahead, evict_on_starve: bool = True
                         ) -> np.ndarray:
        """The active slots that can append `ahead` tokens this step (a
        scalar, or per slot (B,): speculative steps ask 1 + k_b).  Paged
        mode allocates pages to cover them (capped at max_len) and copies
        any still-shared page in the write range (the safety net for exact
        prompt hits); a starved slot stalls, and if nothing can run the
        youngest active slot is evicted until something can, unless
        `evict_on_starve` is off: then the all-stalled plan is returned for
        the caller to retry with a smaller ask.  Dense: every active
        slot."""
        if not self.paged:
            return self.active.copy()
        ahead = np.broadcast_to(np.asarray(ahead, np.int32), (self.B,))
        cow_pairs: List[Tuple[int, int]] = []
        while True:
            run = self.active.copy()
            for b in np.flatnonzero(self.active):
                b = int(b)
                upto = min(int(self.lengths[b]) + int(ahead[b]), self.max_len)
                if not (self._alloc_slot(b, upto)
                        and self._cow_range(b, int(self.lengths[b]), upto,
                                            cow_pairs)):
                    run[b] = False
            if run.any() or not self.active.any() or not evict_on_starve:
                break
            self._evict(self._eviction_victim())
            # a copy into a page the eviction just freed must not run
            cow_pairs[:] = [pr for pr in cow_pairs if self.page_ref[pr[1]] > 0]
        self._apply_copies(cow_pairs)
        self._note_peak()
        return run

    def _slot_rids_gens(self) -> Tuple[np.ndarray, np.ndarray]:
        """(rids, gens) of every slot for `_row_keys` (0 for empty slots,
        whose samples are discarded)."""
        rids = np.zeros(self.B, np.int32)
        gens = np.zeros(self.B, np.int32)
        for b, r in enumerate(self.slot_req):
            if r is not None:
                rids[b] = r.rid
                gens[b] = len(r.tokens)
        return rids, gens

    def _slot_ids(self) -> Dict[str, Any]:
        rids, gens = self._slot_rids_gens()
        return dict(rids=rids, gens=gens, sampling=self.sampling)

    def _decode(self, emitted: Dict[int, List[int]]):
        if not self.active.any():
            return
        run = self._plan_decode_run(self.decode_chunk)
        if not run.any():
            return
        self.model_steps += self.decode_chunk
        # stalled rows advertise length 0 for the chunk (their writes go to
        # the trash page, attention runs no partition) and keep their state
        tok, lengths, active, remaining, toks, em, pois = ragged_decode(
            self.model, self.params, self.cache, self.cur_tok,
            self.lengths * run, run, self.remaining, self.decode_chunk,
            self.eos_id, self.max_len,
            self.page_table if self.paged else None, **self._slot_ids(),
            poison=self._poison_mask & run)
        stalled = self.active & ~run
        self.cur_tok = np.where(run, tok, self.cur_tok).astype(np.int32)
        self.lengths = np.where(run, lengths, self.lengths).astype(np.int32)
        self.active = active | stalled
        self.remaining = remaining.astype(np.int32)
        for b in range(self.B):
            r = self.slot_req[b]
            if r is None:
                continue
            step_toks = [int(t) for t in toks[em[:, b], b]]
            if step_toks:
                r.tokens.extend(step_toks)
                emitted.setdefault(r.rid, []).extend(step_toks)
            if pois[b]:
                self.n_poisoned += 1
                self._retire(b, status="poisoned", register=False)
            elif not self.active[b] and not self.prefilling[b]:
                # prefilling slots are not in the chunk
                self._retire(b)

    # -- mixed prefill+decode steps -----------------------------------------
    def _finish_prefill(self, slot: int, tok0: int,
                        emitted: Dict[int, List[int]]):
        """A chunk completed `slot`'s prompt: publish its prefixes, record
        its first token, and retire it or move it to decoding."""
        r = self.slot_req[slot]
        pend = self._pend[slot]
        self.prefilling[slot] = False
        self._pend[slot] = None
        if self.paged and self.prefix_sharing:
            self._inflight_keys.pop(slot, None)
            self._register_prefixes(slot, pend, exact=False)
        budget_left = r.max_new_tokens - len(r.tokens)
        r.tokens.append(tok0)
        emitted.setdefault(r.rid, []).append(tok0)
        self.lengths[slot] = len(pend)
        self.cur_tok[slot] = tok0
        self.remaining[slot] = budget_left - 1
        if ((self.eos_id is not None and tok0 == self.eos_id)
                or budget_left <= 1 or len(pend) >= self.max_len):
            self._retire(slot)
        else:
            self.active[slot] = True

    def _post_decode_token(self, slot: int, tok: int,
                           emitted: Dict[int, List[int]]):
        """Bookkeeping of one decode token of a mixed step: the retirement
        rules of the decode chunk (EOS, budget, capacity)."""
        r = self.slot_req[slot]
        r.tokens.append(tok)
        emitted.setdefault(r.rid, []).append(tok)
        self.remaining[slot] -= 1
        new_len = int(self.lengths[slot]) + 1
        if ((self.eos_id is not None and tok == self.eos_id)
                or self.remaining[slot] <= 0 or new_len >= self.max_len):
            self._retire(slot)
        else:
            self.lengths[slot] = new_len
            self.cur_tok[slot] = tok

    def _effective_chunk_budget(self) -> int:
        """The per-step prefill token budget, halved from ladder level 2
        (prefill chunks are a step's widest work)."""
        if self.ladder_level >= 2:
            return max(1, self.prefill_chunk_budget // 2)
        return self.prefill_chunk_budget

    def _plan_chunks(self) -> List[Tuple[int, int, int]]:
        """This step's prefill chunks as (slot, start, end): the budget
        handed out FCFS in admission order, each chunk cut by
        `plan_prefill_chunk`."""
        budget = self._effective_chunk_budget()
        chunks: List[Tuple[int, int, int]] = []
        for b in sorted(np.flatnonzero(self.prefilling),
                        key=lambda b: self._admit_seq[b]):
            if budget <= 0:
                break
            start = int(self.lengths[b])
            end = plan_prefill_chunk(start, len(self._pend[b]), budget,
                                     self.page_size if self.paged else 0)
            chunks.append((int(b), start, end))
            budget -= end - start
        return chunks

    def _chunks_done(self, chunks, tok, fin, rows,
                     emitted: Dict[int, List[int]]):
        """Advance each chunk's slot; a chunk that completes its prompt
        gives the slot its first token (row rows[i] of `tok` / `fin`)."""
        for i, (b, _, e) in enumerate(chunks):
            self.lengths[b] = e
            if e == len(self._pend[b]):
                if fin[rows[i]]:
                    self._finish_prefill(b, int(tok[rows[i]]), emitted)
                else:
                    self.n_poisoned += 1
                    self._retire(b, status="poisoned", register=False)

    def _chunk_prefill_wave(self, emitted: Dict[int, List[int]]):
        """Paired mixed step, prefill half: only the prefilling slots' rows
        of the page table run, through the admission prefill at the
        chunks' offsets."""
        chunks = self._plan_chunks()
        if not chunks:
            return
        n = len(chunks)
        toks = np.zeros((n, self._bucket(max(e - s for _, s, e in chunks))),
                        np.int32)
        for i, (b, s, e) in enumerate(chunks):
            toks[i, :e - s] = self._pend[b][s:e]
        slots = np.array([b for b, _, _ in chunks], np.int32)
        offs = np.array([s for _, s, _ in chunks], np.int32)
        lens = np.array([e - s for _, s, e in chunks], np.int32)
        rids, gens = self._slot_rids_gens()
        self.prefill_tokens_computed += int(lens.sum())
        self.model_steps += 1
        tok0, fin = paged_prefill(self.model, self.params, toks, lens,
                                  self.cache, self.page_table[slots], offs,
                                  rids=rids[slots], gens=gens[slots],
                                  sampling=self.sampling)
        self._chunks_done(chunks, tok0, fin, range(n), emitted)

    def _mixed_step_fused(self, emitted: Dict[int, List[int]]):
        """Fused mixed step: one (B, L) forward in which every decoding
        slot that can extend brings 1 token at column 0, prefilling slots
        their chunk and idle rows nothing."""
        run = self._plan_decode_run(1)
        chunks = self._plan_chunks()
        if not chunks and not run.any():
            return
        L = self._bucket(max([e - s for _, s, e in chunks] + [1]))
        toks = np.zeros((self.B, L), np.int32)
        offs = np.zeros(self.B, np.int32)
        seq = np.zeros(self.B, np.int32)
        dec = np.zeros(self.B, bool)
        for b, s, e in chunks:
            toks[b, :e - s] = self._pend[b][s:e]
            offs[b] = s
            seq[b] = e - s
        for b in np.flatnonzero(run):
            toks[b, 0] = self.cur_tok[b]
            offs[b] = self.lengths[b]
            seq[b] = 1
            dec[b] = True
        self.prefill_tokens_computed += sum(e - s for _, s, e in chunks)
        self.model_steps += 1
        tok, fin = mixed_step(self.model, self.params, toks, self.cache, offs,
                              seq, dec, self.page_table if self.paged else None,
                              **self._slot_ids(),
                              poison=self._poison_mask & (seq > 0))
        self._chunks_done(chunks, tok, fin, [b for b, _, _ in chunks], emitted)
        for b in np.flatnonzero(dec):
            if fin[b]:
                self._post_decode_token(int(b), int(tok[b]), emitted)
            else:
                self.n_poisoned += 1
                self._retire(int(b), status="poisoned", register=False)

    def _mixed_step(self, emitted: Dict[int, List[int]]):
        """One mixed step: "fused" runs both row classes in one forward,
        "paired" a chunk wave of the prefilling rows and then the decode
        chunk, back to back on one stream."""
        if self.mixed_dispatch == "paired":
            self._chunk_prefill_wave(emitted)
            self._decode(emitted)
        else:
            self._mixed_step_fused(emitted)

    # -- speculative decoding -----------------------------------------------
    def _propose(self, slot: int) -> List[int]:
        """Drafts for `slot`, capped so that a step accepting all of them
        overruns neither the token budget (it emits k + 1 tokens) nor the
        cache capacity (k + 1 writes from the slot's fill)."""
        r = self.slot_req[slot]
        if r.spec_k is None:
            r.spec_k = self.draft_len
        cap = min(r.spec_k, int(self.remaining[slot]) - 1,
                  self.max_len - int(self.lengths[slot]) - 1)
        if cap < 1:
            return []
        return propose_draft_tokens(r.prompt + r.tokens, cap,
                                    eos_id=self.eos_id)

    def _spec_step(self, emitted: Dict[int, List[int]],
                   with_chunks: bool = False):
        """One speculative step: drafts for every decoding slot, verified
        (with this step's prefill chunks when `with_chunks`) in one
        forward, then each row's accepted prefix and bonus or correction
        token through the per-token retirement rules.  Paged allocation
        asks for 1 + k_b writes without evicting; slots the pool cannot
        stretch drop their drafts (k_b = 0), and only if that starves too
        does the regular evict-youngest plan run, so speculation never
        evicts a neighbour to chase drafts."""
        chunks = self._plan_chunks() if with_chunks else []
        drafts: List[List[int]] = [[] for _ in range(self.B)]
        karr = np.zeros(self.B, np.int32)
        for b in np.flatnonzero(self.active):
            drafts[b] = self._propose(int(b))
            karr[b] = len(drafts[b])
        run = self._plan_decode_run(1 + karr, evict_on_starve=False)
        starved = self.active & ~run
        if starved.any():
            karr[starved] = 0
            for b in np.flatnonzero(starved):
                drafts[b] = []
            run = self._plan_decode_run(1 + karr)
        if not chunks and not run.any():
            return
        P = self.draft_len + 1
        # P columns cover every verify row; a step carrying chunks widens
        # to their bucket
        L = (max(P, self._bucket(max(e - s for _, s, e in chunks)))
             if chunks else P)
        toks = np.zeros((self.B, L), np.int32)
        offs = np.zeros(self.B, np.int32)
        seq = np.zeros(self.B, np.int32)
        dec = np.zeros(self.B, bool)
        for b, s, e in chunks:
            toks[b, :e - s] = self._pend[b][s:e]
            offs[b] = s
            seq[b] = e - s
        for b in np.flatnonzero(run):
            k = int(karr[b])
            toks[b, 0] = self.cur_tok[b]
            toks[b, 1:1 + k] = drafts[b]
            offs[b] = self.lengths[b]
            seq[b] = 1 + k
            dec[b] = True
        self.prefill_tokens_computed += sum(e - s for _, s, e in chunks)
        self.model_steps += 1
        self.n_spec_steps += 1
        out, n_emit, fin = spec_step(
            self.model, self.params, toks, self.cache, offs, seq, dec, P,
            self.page_table if self.paged else None, **self._slot_ids(),
            poison=self._poison_mask & (seq > 0))
        self._chunks_done(chunks, out[:, 0], fin, [b for b, _, _ in chunks],
                          emitted)
        for b in np.flatnonzero(dec):
            b = int(b)
            if not fin[b]:
                # nothing of the step is emitted; draft counters untouched
                self.n_poisoned += 1
                self._retire(b, status="poisoned", register=False)
                continue
            r = self.slot_req[b]
            k, m = int(karr[b]), int(n_emit[b])
            if k:
                a = m - 1
                self.spec_proposed += k
                self.spec_accepted += a
                self.spec_rejected += k - a
                if a == k:
                    r.spec_k = min(self.draft_len, r.spec_k + 1)
                elif a == 0:
                    r.spec_k = max(1, r.spec_k // 2)
            for j in range(m):
                self._post_decode_token(b, int(out[b, j]), emitted)
                if self.slot_req[b] is None:
                    break      # retired inside the prefix: the rest is dropped

    # -- SLA degradation ladder ---------------------------------------------
    def _under_pressure(self) -> bool:
        """Either signal over its target: the p95 queue depth of the last
        32 steps above `queue_depth_target`, or the p95 time between steps
        (on the injectable clock) above `tbt_target_ms`."""
        depths = self._queue_depths[-32:]
        if depths and (float(np.percentile(np.asarray(depths), 95))
                       > self.queue_depth_target):
            return True
        return bool(self._tbt_samples) and float(np.percentile(
            np.asarray(self._tbt_samples), 95)) * 1e3 > self.tbt_target_ms

    def _ladder_update(self):
        """At most one rung per cooldown window: up while the pressure
        holds, down (reverse order) once it clears.  The rungs act where
        the level is read (speculation at >= 1, the chunk budget at >= 2,
        admission at 3), so a restore resumes mid-ladder as it was."""
        if self.tbt_target_ms <= 0:
            return
        if (self._step_idx - self._ladder_last_change
                < self.ladder_cooldown_steps):
            return
        if self._under_pressure():
            if self.ladder_level < len(LADDER_RUNGS):
                self.ladder_transitions[LADDER_RUNGS[self.ladder_level]] += 1
                self.ladder_level += 1
                self.ladder_escalations += 1
                self._ladder_last_change = self._step_idx
        elif self.ladder_level > 0:
            self.ladder_level -= 1
            self.ladder_deescalations += 1
            self._ladder_last_change = self._step_idx

    def _sample_tbt(self):
        if self.tbt_target_ms <= 0:
            return
        now = self._clock()
        if self._last_step_time is not None:
            self._tbt_samples.append(now - self._last_step_time)
        self._last_step_time = now

    # -- fault hooks with scheduler state -------------------------------------
    def _bitflip_victim_page(self):
        """Fault hook: flip one byte (XOR 0xFF) of the lowest-rid victim
        record's host bytes, the first byte of the first leaf of its page
        tree.  The spill-time crcs no longer match, so the restore must
        detect it and recompute the request from its prompt."""
        for rid in sorted(self._victim):
            rec = self._victim[rid]
            if rec.n_host and rec.data is not None:
                leaves = ckpt.flatten(rec.data)
                leaf = leaves[0].clone()
                flat = leaf.view(-1).view(torch.uint8)
                flat[0] = flat[0] ^ 0xFF
                rec.data = ckpt.unflatten(rec.data, [leaf] + leaves[1:])
                self.bitflips_injected += 1
                return

    # -- crash recovery: snapshot and restore ---------------------------------
    def _config_fingerprint(self) -> Dict[str, Any]:
        """The configuration a snapshot's continuation depends on, checked
        at restore (another one would resume with other streams)."""
        sp = self.sampling
        return {
            "arch": self.model.cfg.name, "kv_bits": self.model.cfg.kv_bits,
            "B": self.B, "max_len": self.max_len, "eos_id": self.eos_id,
            "temperature": sp.temperature, "top_k": sp.top_k,
            "top_p": sp.top_p, "decode_chunk": self.decode_chunk,
            "prefill_bucket": self.prefill_bucket,
            "page_size": self.page_size if self.paged else 0,
            "num_pages": self.num_pages if self.paged else 0,
            "prefix_sharing": self.prefix_sharing,
            "mixed_steps": self.mixed_steps,
            "mixed_dispatch": self.mixed_dispatch,
            "speculate": self.speculate, "draft_len": self.draft_len,
            "draft_mode": self.draft_mode,
        }

    _COUNTERS = ("n_evictions", "n_spills", "n_restores", "spilled_pages",
                 "spill_bytes", "n_recompute_fallbacks", "n_deadline_misses",
                 "n_rejections", "n_reclaim_stalls",
                 "refcount_corruptions_detected", "model_steps",
                 "n_spec_steps", "spec_proposed", "spec_accepted",
                 "spec_rejected", "prefix_hits", "prefix_hit_tokens",
                 "prefill_tokens_computed", "n_cow_copies",
                 "prefix_evictions", "corruptions_detected",
                 "bitflips_injected", "n_poisoned", "n_snapshots")

    @staticmethod
    def _owned(rec: _SpillRecord) -> _SpillRecord:
        """`rec` with host planes in storage of their own: a spill's planes
        are views of one buffer, which pickling would write once a plane."""
        data = None if rec.data is None else ckpt.unflatten(
            rec.data, [t.clone() for t in ckpt.flatten(rec.data)])
        return _SpillRecord(rec.logical, rec.n_host, rec.width, data,
                            rec.covered, rec.cur_tok, rec.crcs)

    @torch.inference_mode()
    def snapshot(self, directory: Optional[str] = None) -> str:
        """Write a checkpoint generation of the whole scheduler (default
        directory: `snapshot_dir`) and return its path.  Three leaves: the
        cache's planes (copied off the device), the sampling key, and one
        pickled blob of the host state (requests, queue, slots, page
        tables and refcounts, directory, quarantine, crcs, victim records
        with their host bytes, ladder, fault state, counters).  Taken at
        the end of a step, when nothing is in flight, so that `restore`
        continues every stream bit for bit."""
        directory = directory or self.snapshot_dir
        if not directory:
            raise ValueError("snapshot() needs a directory "
                             "(snapshot_dir or an explicit argument)")
        meta: Dict[str, Any] = {
            "config": self._config_fingerprint(),
            "step_idx": self._step_idx, "next_rid": self._next_rid,
            "requests": self.requests,
            "queue": [r.rid for r in self.queue],
            "slot_req": [None if r is None else r.rid
                         for r in self.slot_req],
            "lengths": self.lengths, "active": self.active,
            "remaining": self.remaining, "cur_tok": self.cur_tok,
            "prefilling": self.prefilling, "pend": self._pend,
            "inflight_keys": self._inflight_keys,
            "admit_seq": self._admit_seq,
            "admit_counter": self._admit_counter,
            "victim": {rid: self._owned(rec)
                       for rid, rec in self._victim.items()},
            "victim_used": self._victim_used,
            "queue_depths": self._queue_depths,
            "counters": {k: getattr(self, k) for k in self._COUNTERS},
            "ladder": {
                "level": self.ladder_level,
                "escalations": self.ladder_escalations,
                "deescalations": self.ladder_deescalations,
                "paused_steps": self.ladder_paused_steps,
                "transitions": dict(self.ladder_transitions),
                "last_change": self._ladder_last_change,
            },
            "integrity": {"page_crc": dict(self.page_crc),
                          "quarantined": set(self.quarantined),
                          "poison_mask": self._poison_mask.copy()},
            "faults": (None if self._faults is None else
                       (dict(self._faults.fired),
                        self._faults._rng.get_state())),
        }
        if self.paged:
            meta["paged"] = {
                "page_table": self.page_table, "page_ref": self.page_ref,
                "free_pages": list(self.free_pages),
                "prefix_dir": self.prefix_dir,
                "dir_ref": dict(self._dir_ref),
                "peak_pages_in_use": self.peak_pages_in_use,
            }
        tree = {"cache": self.cache,
                "meta": np.frombuffer(pickle.dumps(meta), np.uint8),
                "rng": self.sampling.key}
        path = ckpt.save(directory, self._step_idx, tree)
        self.n_snapshots += 1
        return path

    @torch.inference_mode()
    def restore(self, directory: Optional[str] = None) -> int:
        """Load the newest intact snapshot generation (default directory:
        `snapshot_dir`) into this scheduler, which must have the
        snapshot's configuration (checked), and return its step; `run()`
        then continues every stream bit for bit.  The pool's bytes are
        copied into this scheduler's cache in place.  With integrity on,
        directory-held pages are checksummed once the bytes are in: a
        mismatch (corruption older than the snapshot) quarantines every
        entry holding such a page.  Victim records are verified at their
        re-admission."""
        directory = directory or self.snapshot_dir
        if not directory:
            raise ValueError("restore() needs a directory "
                             "(snapshot_dir or an explicit argument)")
        like = {"cache": self.cache, "meta": np.zeros(0, np.uint8),
                "rng": self.sampling.key}
        tree, step = ckpt.restore_latest(directory, like)
        if tree is None:
            raise FileNotFoundError(
                f"no restorable snapshot generation in {directory}")
        meta = pickle.loads(tree["meta"].numpy().tobytes())
        mine = self._config_fingerprint()
        if meta["config"] != mine:
            diff = {k: (meta["config"].get(k), mine.get(k))
                    for k in set(meta["config"]) | set(mine)
                    if meta["config"].get(k) != mine.get(k)}
            raise ValueError(
                f"snapshot config mismatch (snapshot vs this): {diff}")
        for dst, src in zip(ckpt.flatten(self.cache),
                            ckpt.flatten(tree["cache"])):
            dst.copy_(src)
        self.sampling.key = tree["rng"]
        self._step_idx = int(meta["step_idx"])
        self._next_rid = int(meta["next_rid"])
        self.requests = meta["requests"]
        self.queue = collections.deque(
            self.requests[rid] for rid in meta["queue"])
        self.slot_req = [None if rid is None else self.requests[rid]
                         for rid in meta["slot_req"]]
        self.lengths = np.asarray(meta["lengths"], np.int32).copy()
        self.active = np.asarray(meta["active"], bool).copy()
        self.remaining = np.asarray(meta["remaining"], np.int32).copy()
        self.cur_tok = np.asarray(meta["cur_tok"], np.int32).copy()
        self.prefilling = np.asarray(meta["prefilling"], bool).copy()
        self._pend = list(meta["pend"])
        self._inflight_keys = dict(meta["inflight_keys"])
        self._admit_seq = np.asarray(meta["admit_seq"], np.int64).copy()
        self._admit_counter = int(meta["admit_counter"])
        self._victim = dict(meta["victim"])
        self._victim_used = int(meta["victim_used"])
        self._queue_depths = list(meta["queue_depths"])
        for k, v in meta["counters"].items():
            setattr(self, k, v)
        lad = meta["ladder"]
        self.ladder_level = int(lad["level"])
        self.ladder_escalations = int(lad["escalations"])
        self.ladder_deescalations = int(lad["deescalations"])
        self.ladder_paused_steps = int(lad["paused_steps"])
        self.ladder_transitions = dict(lad["transitions"])
        self._ladder_last_change = int(lad["last_change"])
        # times between steps on the clock do not carry across a crash
        self._tbt_samples.clear()
        self._last_step_time = None
        self.page_crc = dict(meta["integrity"]["page_crc"])
        self.quarantined = set(meta["integrity"]["quarantined"])
        # a slot marked for poison but not yet retired still retires
        self._poison_mask[:] = np.asarray(meta["integrity"]["poison_mask"],
                                          bool)
        if self.paged:
            pg = meta["paged"]
            self.page_table = np.asarray(pg["page_table"], np.int32).copy()
            self.page_ref = np.asarray(pg["page_ref"], np.int32).copy()
            self.free_pages = list(pg["free_pages"])
            self.prefix_dir = collections.OrderedDict(pg["prefix_dir"])
            self._dir_ref = dict(pg["dir_ref"])
            self.peak_pages_in_use = int(pg["peak_pages_in_use"])
        if self._faults is not None:
            if meta["faults"] is not None:
                fired, rng_state = meta["faults"]
                self._faults.fired = dict(fired)
                self._faults._rng.set_state(rng_state)
            if self._faults.plan.crash_at_step:
                # the crash has happened: a plan that still names it must
                # not fire again
                self._faults.fired["crash"] = max(
                    1, self._faults.fired.get("crash", 0))
        if self.integrity != "off" and self.page_crc:
            pages = sorted(self.page_crc)
            crcs = self._compute_page_crcs(pages)
            bad = {p for p, c in zip(pages, crcs) if c != self.page_crc[p]}
            if bad:
                self.corruptions_detected += len(bad)
                for key in [k for k, (pp, _) in self.prefix_dir.items()
                            if bad & set(pp)]:
                    self._quarantine_entry(key)
        return int(step)

    # -- driving --------------------------------------------------------------
    @torch.inference_mode()
    def step(self) -> Dict[int, List[int]]:
        """One scheduling round: shed stale requests, move the ladder,
        admit (restoring spilled continuations) unless the ladder pauses
        admission, then one speculative step (with this step's prefill
        chunks, or after a paired chunk wave; not from ladder level 1), or
        one mixed step while a prompt is being prefilled in chunks, else
        one decode chunk; returns the tokens generated this round by
        request id.  The fault plan's hooks, the per-step audit and the
        periodic snapshot run here, in the reference's order."""
        emitted: Dict[int, List[int]] = {}
        self._step_idx += 1
        if (self._faults is not None
                and self._faults.should_crash(self._step_idx)):
            # before any work: the newest snapshot is the durable state
            raise CrashInjected(f"injected crash at step {self._step_idx}")
        self._shed_stale()
        self._shed_admitted()
        self._queue_depths.append(len(self.queue))
        self._ladder_update()
        if (self.ladder_level >= 3
                and any(r is not None for r in self.slot_req)):
            # the deepest rung pauses admission while residents drain, but
            # never with every slot empty (nothing would drain the queue)
            self.ladder_paused_steps += 1
        else:
            self._admit(emitted)
        if (self._faults is not None and self.active.any()
                and self._faults.force_evict(self._step_idx)):
            self._evict(self._eviction_victim())
        if (self._faults is not None and self._victim
                and self._faults.bitflip_spilled_page(self._step_idx)):
            self._bitflip_victim_page()
        occupied = self.active | self.prefilling
        if (self._faults is not None and occupied.any()
                and self._faults.poison_nan(self._step_idx)):
            # the occupied slot with the lowest rid; the mark stays until
            # the slot is vacated, so a victim that samples nothing this
            # step retires at its next sampled logits
            victim = min((int(b) for b in np.flatnonzero(occupied)),
                         key=lambda b: self.slot_req[b].rid)
            self._poison_mask[victim] = True
        filling = self.mixed_steps and self.prefilling.any()
        if self.speculate and self.ladder_level < 1:
            if filling and self.mixed_dispatch == "paired":
                self._chunk_prefill_wave(emitted)
                self._spec_step(emitted)
            else:
                self._spec_step(emitted, with_chunks=filling)
        elif filling:
            self._mixed_step(emitted)
        else:
            self._decode(emitted)
        self._note_peak()
        if (self._faults is not None and self.paged
                and self._faults.corrupt_refcount(self._step_idx)):
            self._corrupt_and_detect()
        if self._audit_every:
            self.audit()
        if self.snapshot_every and self._step_idx % self.snapshot_every == 0:
            self.snapshot()
        self._sample_tbt()
        return emitted

    def run(self, on_tokens: Optional[Callable[[int, List[int]], None]] = None
            ) -> Dict[int, List[int]]:
        """Drive steps until every submitted request is done; returns
        {request id: generated tokens}.  `on_tokens(rid, new_tokens)`
        streams the deltas."""
        results: Dict[int, List[int]] = {}
        while self.queue or any(r is not None for r in self.slot_req):
            for rid, toks in self.step().items():
                results.setdefault(rid, []).extend(toks)
                if on_tokens is not None:
                    on_tokens(rid, toks)
        return results

    def results(self) -> Dict[int, List[int]]:
        """The token stream of every request ever submitted, done or not."""
        return {rid: list(r.tokens) for rid, r in self.requests.items()}

    @property
    def stats(self) -> Dict[str, Any]:
        depths = np.asarray(self._queue_depths or [0])
        return {
            "steps": self._step_idx,
            "model_steps": self.model_steps,
            "spec_steps": self.n_spec_steps,
            "spec_proposed": self.spec_proposed,
            "spec_accepted": self.spec_accepted,
            "spec_rejected": self.spec_rejected,
            "spec_accept_rate": (self.spec_accepted
                                 / max(self.spec_proposed, 1)),
            "evictions": self.n_evictions,
            "spills": self.n_spills,
            "restores": self.n_restores,
            "spilled_pages": self.spilled_pages,
            "spill_bytes": self.spill_bytes,
            "kv_bytes_per_token": kv_bytes_per_token(self.model.cfg),
            "recompute_fallbacks": self.n_recompute_fallbacks,
            "deadline_misses": self.n_deadline_misses,
            "rejections": self.n_rejections,
            "reclaim_stalls": self.n_reclaim_stalls,
            "refcount_corruptions_detected":
                self.refcount_corruptions_detected,
            "victim_pool_pages_used": self._victim_used,
            "queue_depth_p50": float(np.percentile(depths, 50)),
            "queue_depth_p95": float(np.percentile(depths, 95)),
            "corruptions_detected": self.corruptions_detected,
            "bitflips_injected": self.bitflips_injected,
            "poisoned": self.n_poisoned,
            "quarantined_prefixes": len(self.quarantined),
            "snapshots": self.n_snapshots,
            "ladder_level": self.ladder_level,
            "ladder_escalations": self.ladder_escalations,
            "ladder_deescalations": self.ladder_deescalations,
            "ladder_paused_steps": self.ladder_paused_steps,
            "ladder_transitions": dict(self.ladder_transitions),
            "tbt_p95_ms": (float(np.percentile(
                np.asarray(self._tbt_samples), 95)) * 1e3
                if self._tbt_samples else 0.0),
        }

    def _corrupt_and_detect(self):
        """Fault hook: add one to the refcount of the lowest held page,
        require `audit()` to detect it, then roll it back."""
        held = np.flatnonzero(self.page_ref > 0)
        if held.size == 0:
            return
        p = int(held[0])
        self.page_ref[p] += 1
        try:
            self.audit()
        except AuditError:
            self.refcount_corruptions_detected += 1
        else:
            raise AssertionError(
                f"audit() missed an injected refcount corruption on page {p}")
        finally:
            self.page_ref[p] -= 1

    def audit(self):
        """Check the slot and page-accounting invariants; raises
        `AuditError` listing every violation.  Slots: no active or
        prefilling slot without a request, never both, a prefilling slot
        has its pending tokens.  Paged: each page's refcount equals its
        holders (table entries + directory entries), refcount 0 iff on the
        free list, no page twice on the free list, the trash page never
        handed out, table rows contiguous and covering their slot's fill,
        the directory's per-page holds in sync with its entries, no
        quarantined key in it, crcs only for directory-held pages, and the
        victim pool's records holding their shared pages (each a holder)
        and as many host pages as its counter says, within its cap; under
        paranoid integrity also every record's host bytes against its
        spill-time crcs."""
        errs: List[str] = []
        for b in range(self.B):
            occupied = self.slot_req[b] is not None
            if not occupied and self.active[b]:
                errs.append(f"slot {b}: active without a request")
            if not occupied and self.prefilling[b]:
                errs.append(f"slot {b}: prefilling without a request")
            if self.active[b] and self.prefilling[b]:
                errs.append(f"slot {b}: both active and prefilling")
            if self.prefilling[b] and self._pend[b] is None:
                errs.append(f"slot {b}: prefilling with no pending tokens")
        if self.paged:
            P = self.num_pages
            free_set = set(self.free_pages)
            if len(free_set) != len(self.free_pages):
                errs.append("free list holds duplicate pages (double-free)")
            if TRASH_PAGE in free_set:
                errs.append("reserved trash page is on the free list")
            for p in free_set:
                if not 0 < p < P:
                    errs.append(f"free list holds out-of-range page {p}")
            expected = np.zeros(P, np.int64)
            for b in range(self.B):
                row = self.page_table[b]
                k = int((row >= 0).sum())
                if k and not (row[:k] >= 0).all():
                    errs.append(f"slot {b}: page-table row is not a "
                                "contiguous allocated prefix")
                for p in row[row >= 0]:
                    if not 0 < p < P:
                        errs.append(f"slot {b}: invalid page id {int(p)}")
                    else:
                        expected[p] += 1
                if self.slot_req[b] is None and k:
                    errs.append(f"slot {b}: empty slot still maps {k} pages")
                if (self.slot_req[b] is not None and self.lengths[b] > 0
                        and k < self._pages_for(int(self.lengths[b]))):
                    errs.append(f"slot {b}: kv fill {int(self.lengths[b])} "
                                f"not covered by its {k} pages")
            dir_ref: Dict[int, int] = {}
            for pages, _ in self.prefix_dir.values():
                for p in pages:
                    dir_ref[p] = dir_ref.get(p, 0) + 1
                    if 0 < p < P:
                        expected[p] += 1
                    else:
                        errs.append(f"directory maps invalid page {p}")
            if dir_ref != self._dir_ref:
                errs.append("directory page holds (_dir_ref) out of sync "
                            "with the directory's entries")
            # integrity: a quarantined prefix never re-enters, and crcs
            # are kept only for directory-held (immutable) pages
            for key in self.quarantined:
                if key in self.prefix_dir:
                    errs.append("quarantined prefix key re-entered the "
                                "directory")
            for p in self.page_crc:
                if p not in self._dir_ref:
                    errs.append(f"page {p}: write-time checksum recorded "
                                "but page is not directory-held")
            if self.integrity == "paranoid":
                # the victim pool's host bytes against their spill crcs
                for rid, rec in self._victim.items():
                    if self._victim_mismatches(rec):
                        errs.append(f"victim record {rid}: host page bytes "
                                    "no longer match their spill-time "
                                    "checksums")
            used = 0
            for rid, rec in self._victim.items():
                used += rec.n_host
                for kind, p in rec.logical:
                    if kind != "ref":
                        continue
                    if 0 < p < P:
                        expected[p] += 1
                    else:
                        errs.append(f"victim record {rid} holds invalid "
                                    f"page {p}")
            if used != self._victim_used:
                errs.append(f"victim pool accounting: records hold {used} "
                            f"host pages, counter says {self._victim_used}")
            if self.victim_pool_pages and used > self.victim_pool_pages:
                errs.append(f"victim pool over capacity: {used} > "
                            f"{self.victim_pool_pages}")
            for p in range(1, P):
                ref = int(self.page_ref[p])
                if ref != int(expected[p]):
                    errs.append(f"page {p}: refcount {ref} != "
                                f"{int(expected[p])} holders")
                if (ref == 0) != (p in free_set):
                    errs.append(f"page {p}: refcount {ref} but "
                                f"{'not ' if ref == 0 else ''}on the free list")
            if int(self.page_ref[TRASH_PAGE]) != 0:
                errs.append("reserved trash page has a nonzero refcount")
        if errs:
            raise AuditError("scheduler audit failed:\n  " + "\n  ".join(errs))


# ---------------------------------------------------------------------------
# generate entry points
# ---------------------------------------------------------------------------
def generate(model: Model, params, prompt_batch: Dict[str, torch.Tensor],
             max_new_tokens: int, max_len: int, temperature: float = 0.0,
             top_k: int = 0, top_p: float = 1.0,
             rng: Optional[torch.Tensor] = None,
             continuous_batching: bool = False,
             eos_id: Optional[int] = None, decode_chunk: int = 8,
             max_batch_slots: Optional[int] = None, page_size: int = 0,
             num_pages: int = 0, prefix_sharing: bool = False,
             prefix_cache_pages: int = 0, mixed_steps: bool = False,
             prefill_chunk_budget: int = 0, mixed_dispatch: str = "fused",
             speculate: bool = False, draft_len: int = 4,
             draft_mode: str = "ngram", victim_pool_pages: int = 0,
             max_queue: int = 0, deadline_ms: Optional[float] = None,
             ttl_steps: Optional[int] = None,
             fault_plan: Optional[FaultPlan] = None, kv_bits: int = 0,
             integrity: str = "off", tbt_target_ms: float = 0.0,
             snapshot_every: int = 0, snapshot_dir: Optional[str] = None,
             restore_from: Optional[str] = None) -> torch.Tensor:
    """Batched generation; returns (B, max_new_tokens) token ids.

    Default: equal-length prefill (with the batch's `image_embeds` or an
    encoder-decoder's `frames`, where it carries them: the cross K/V are
    written there once), then one decode step per further token (tokens
    only);
    greedy at temperature 0, else sampled (top_k- and / or top_p-truncated)
    with the threefry key `rng` (default `PRNGKey(0)`), split as the
    reference splits it: one subkey for the prefill's tokens, then one per
    step.  With `continuous_batching=True` it is one `Scheduler` run over
    `max_batch_slots` slots (default: the batch size), retiring rows at
    `eos_id` and padding them with it (or 0); `page_size > 0` puts the
    slots on the paged pool of `num_pages` pages, `prefix_sharing` shares
    prompt prefixes there (`prefix_cache_pages` caps the directory),
    `mixed_steps` prefills prompts in chunks of `prefill_chunk_budget`
    tokens beside the decoding slots, `speculate` verifies up to
    `draft_len` drafted tokens a slot and step (`draft_mode`),
    `victim_pool_pages` spills evicted slots to host memory, `max_queue`,
    `deadline_ms` and `ttl_steps` bound admission (a refused or shed row
    stays padding), and `fault_plan` injects faults (see `Scheduler`).

    `kv_bits` (0: the model's) sets the KV cache's precision for the run,
    on either path.  The Scheduler's recovery options need
    `continuous_batching`: `integrity` ("checksum" | "paranoid") checksums
    KV pages, `tbt_target_ms` turns the SLA ladder on,
    `snapshot_every` / `snapshot_dir` snapshot the scheduler, and
    `restore_from` resumes from the newest snapshot in that directory
    before this batch is submitted."""
    model = with_kv_bits(model, kv_bits)
    tokens = torch.as_tensor(prompt_batch["tokens"])
    B, S = tokens.shape
    rng = (prng.PRNGKey(0) if rng is None
           else torch.as_tensor(rng, dtype=torch.int64)).to(model.device)
    if speculate and not continuous_batching:
        raise ValueError("speculate requires continuous_batching=True "
                         "(drafts are verified by the scheduler's ragged "
                         "decode rows)")
    if not continuous_batching and (integrity != "off" or tbt_target_ms > 0
                                    or snapshot_every or restore_from):
        raise ValueError("integrity / tbt_target_ms / snapshot_every / "
                         "restore_from require continuous_batching=True "
                         "(they are Scheduler features)")
    if continuous_batching:
        sched = Scheduler(model, params, max_batch_slots=max_batch_slots or B,
                          max_len=max_len, eos_id=eos_id,
                          temperature=temperature, top_k=top_k, top_p=top_p,
                          decode_chunk=decode_chunk, rng=rng,
                          page_size=page_size,
                          num_pages=num_pages, prefix_sharing=prefix_sharing,
                          prefix_cache_pages=prefix_cache_pages,
                          mixed_steps=mixed_steps,
                          prefill_chunk_budget=prefill_chunk_budget,
                          mixed_dispatch=mixed_dispatch, speculate=speculate,
                          draft_len=draft_len, draft_mode=draft_mode,
                          victim_pool_pages=victim_pool_pages,
                          max_queue=max_queue, fault_plan=fault_plan,
                          integrity=integrity, tbt_target_ms=tbt_target_ms,
                          snapshot_every=snapshot_every,
                          snapshot_dir=snapshot_dir)
        if restore_from:
            sched.restore(restore_from)
        rows = tokens.cpu().numpy()
        rids: List[Optional[int]] = []
        for b in range(B):
            try:
                rids.append(sched.submit(rows[b].tolist(), max_new_tokens,
                                         deadline_ms=deadline_ms,
                                         ttl_steps=ttl_steps))
            except Overloaded:
                rids.append(None)       # back-pressure: the row stays padding
        results = sched.run()
        out = np.full((B, max_new_tokens), 0 if eos_id is None else int(eos_id),
                      np.int64)
        for b, rid in enumerate(rids):
            if rid is None:
                continue
            got = results.get(rid, [])[:max_new_tokens]
            out[b, :len(got)] = got
        return torch.from_numpy(out).to(model.device)
    if page_size:
        raise ValueError("page_size requires continuous_batching=True")
    tokens = tokens.to(model.device)
    if S + max_new_tokens > max_len + 1:
        raise ValueError(f"prompt {S} + {max_new_tokens} new tokens do not fit "
                         f"a cache of {max_len}")
    cache = model.init_cache(B, max_len)
    first = {"tokens": tokens}
    for k in ("image_embeds", "frames"):        # the prefill only
        if k in prompt_batch:
            first[k] = torch.as_tensor(prompt_batch[k]).to(model.device)
    with torch.inference_mode():
        logits, cache = model.forward_serve(params, first, cache, 0)
        key, sub = prng.split(rng)
        tok = sample_logits(logits, sub, temperature, top_k, top_p)
        out = [tok]
        for t in range(max_new_tokens - 1):
            logits, cache = model.forward_serve(
                params, {"tokens": tok[:, None]}, cache, S + t)
            key, sub = prng.split(key)
            tok = sample_logits(logits, sub, temperature, top_k, top_p)
            out.append(tok)
    return torch.stack(out, dim=1)


def greedy_generate(model: Model, params, prompt_batch, max_new_tokens: int,
                    max_len: int) -> torch.Tensor:
    """Batched greedy decoding (temperature 0 `generate`)."""
    return generate(model, params, prompt_batch, max_new_tokens, max_len)
