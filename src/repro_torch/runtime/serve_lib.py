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
    one Scheduler run.

The Scheduler's host state is numpy, as in the reference.  Each forward
gets its host inputs (tokens, offsets, lengths, page table) in one
asynchronous copy, a decode chunk keeps its evolving lengths on the device,
and the host reads the device once per prefill wave and once per chunk.
The Scheduler decodes greedily: sampled streams need the reference's
per-(request, token index) threefry keys, not ported yet.  Its other
features (prefix sharing, mixed steps, spill, speculation, snapshots, ...)
raise NotImplementedError naming their ROADMAP.md item.
"""
from __future__ import annotations

import collections
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.attention import TRASH_PAGE
from repro_torch.models import transformer as T
from repro_torch.models.model_zoo import Model


def kv_bytes_per_token(cfg: ModelConfig) -> int:
    """Device bytes one cached token costs across all layers: K + V values
    at `cfg.kv_bits` (packed two per byte at 4) plus the two f32 scale
    planes, which exist at every precision."""
    hkv = cfg.num_kv_heads
    value_bytes = 2 * hkv * (cfg.resolved_head_dim * cfg.kv_bits // 8)
    return cfg.num_layers * (value_bytes + 2 * 4 * hkv)


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


class AuditError(AssertionError):
    """`Scheduler.audit()` found a broken invariant of the page accounting."""


def _truncate_logits(l: torch.Tensor, top_k: int, top_p: float) -> torch.Tensor:
    """top_k / nucleus truncation of temperature-scaled float32 logits
    (masked entries -> -inf) over the last axis.

    Nucleus rule: keep the shortest descending-probability prefix whose
    exclusive cumulative mass is below top_p; the boundary token is kept,
    so the set is never empty."""
    V = l.shape[-1]
    if top_k:
        k = min(int(top_k), V)
        if k < V:
            kth = torch.topk(l, k, dim=-1).values[..., -1:]
            l = torch.where(l < kth, float("-inf"), l)
    if top_p < 1.0:
        probs = torch.softmax(l, dim=-1)
        sp, order = torch.sort(probs, dim=-1, descending=True, stable=True)
        exclusive = torch.cumsum(sp, dim=-1) - sp
        keep_sorted = exclusive < top_p
        keep_sorted[..., 0] = True
        keep = torch.empty_like(keep_sorted).scatter_(-1, order, keep_sorted)
        l = torch.where(keep, l, float("-inf"))
    return l


def sample_logits(logits: torch.Tensor, generator: Optional[torch.Generator],
                  temperature: float = 0.0, top_k: int = 0,
                  top_p: float = 1.0) -> torch.Tensor:
    """(B, V) logits -> (B,) token ids: greedy at temperature 0 (first
    maximum on ties), else a categorical draw from the temperature-scaled,
    top_k / top_p truncated distribution with `generator`."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    l = _truncate_logits(logits.float() / temperature, top_k, top_p)
    probs = torch.softmax(l, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


# Scheduler options of the reference that later slices port: the value
# each takes when it is off, and its ROADMAP.md §1 item.
_NOT_PORTED = {
    "prefix_sharing": (False, "5 (c)"), "prefix_cache_pages": (0, "5 (c)"),
    "mixed_steps": (False, "5 (d)"), "prefill_chunk_budget": (0, "5 (d)"),
    "mixed_dispatch": ("fused", "5 (d)"),
    "victim_pool_pages": (0, "5 (e)"), "max_queue": (0, "5 (e)"),
    "deadline_ms": (None, "5 (e)"), "ttl_steps": (None, "5 (e)"),
    "fault_plan": (None, "5 (e)"), "audit_every_step": (None, "5 (e)"),
    "speculate": (False, "5 (f)"), "draft_len": (4, "5 (f)"),
    "draft_mode": ("ngram", "5 (f)"), "kv_bits": (0, "5 (g)"),
    "integrity": ("off", "5 (h)"), "tbt_target_ms": (0.0, "5 (h)"),
    "queue_depth_target": (0, "5 (h)"), "ladder_cooldown_steps": (8, "5 (h)"),
    "snapshot_every": (0, "5 (h)"), "snapshot_dir": (None, "5 (h)"),
    "restore_from": (None, "5 (h)"), "rng": (None, "4"),
}

# smallest admission prefill width; waves pad to the next power-of-two
# multiple of it (capped at the cache length)
PREFILL_BUCKET = 16


def _refuse_unported(options: Dict[str, Any]) -> None:
    """Raise for any reference option set to something the port lacks."""
    for name, value in options.items():
        if name not in _NOT_PORTED:
            raise TypeError(f"unexpected argument {name!r}")
        off, item = _NOT_PORTED[name]
        if value != off:
            raise NotImplementedError(
                f"{name}={value!r}: not ported yet (ROADMAP.md §1 item {item})")


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


def _first_tokens(logits: torch.Tensor):
    """Greedy tokens of a prefill's (n, V) logits, -1 where a row's logits
    are not all finite; one device-to-host copy.  Returns host (tok0, fin)."""
    fin = torch.isfinite(logits).all(dim=-1)
    tok = torch.where(fin, torch.argmax(logits, dim=-1), -1)
    out = torch.stack([tok, fin.long()]).cpu().numpy()
    return out[0].astype(np.int32), out[1].astype(bool)


def ragged_prefill(model: Model, params, toks: np.ndarray, lens: np.ndarray,
                   big_cache, slots: np.ndarray):
    """Admission prefill into dense slots: n left-aligned prompts padded to
    L ((n, L) tokens, (n,) valid lengths) run through one forward over an
    L-token sub-batch ragged cache (padding K/V is written but never
    advertised), whose rows are then copied into the first L positions of
    the big cache's `slots`.  Returns the host (first tokens, finite
    rows)."""
    n, L = toks.shape
    toks_d, lens_d, offs_d, slots_d = to_device(
        (toks, lens, np.zeros(n), slots), model.device)
    sub = model.init_cache(n, L, ragged=True)
    logits, sub = model.forward_serve(params, {"tokens": toks_d}, sub,
                                      offs_d, seq_lens=lens_d)
    T.cache_scatter(big_cache, sub, slots_d.long())
    return _first_tokens(logits)


def paged_prefill(model: Model, params, toks: np.ndarray, lens: np.ndarray,
                  pool, pages: np.ndarray):
    """Admission prefill into the paged pool: the prompts write straight
    into their slots' pages (the (n, max_pages) rows of the page table), no
    sub-batch cache and no copy.  Returns the host (first tokens, finite
    rows)."""
    n = toks.shape[0]
    toks_d, lens_d, offs_d, pages_d = to_device(
        (toks, lens, np.zeros(n), pages), model.device)
    logits, _ = model.forward_serve(params, {"tokens": toks_d}, pool, offs_d,
                                    seq_lens=lens_d, pages=pages_d)
    return _first_tokens(logits)


def ragged_decode(model: Model, params, cache, tok, lengths, active,
                  remaining, chunk: int, eos_id: Optional[int], max_len: int,
                  pages: Optional[np.ndarray] = None):
    """`chunk` greedy decode steps for all slots, from host (B,) arrays.

    Every step writes each active slot's token at its own position, attends
    with per-slot lengths (idle slots run no KV partition), and retires
    rows that hit EOS, their budget or the cache capacity: a retired row's
    length drops to 0 for the rest of the chunk.  A row whose logits are
    not all finite emits nothing, stops and is reported.  The lengths stay
    on the device between steps; the host reads the chunk once at its end.
    Paged callers pass the (B, max_pages) page table, which must cover
    lengths + chunk tokens of every active slot.

    Returns host arrays (tok, lengths, active, remaining, toks (chunk, B),
    emitted (chunk, B) bool, poisoned (B,) bool)."""
    eos = -2 if eos_id is None else int(eos_id)      # -2 matches no token
    arrays = (tok, lengths, active, remaining) + (
        () if pages is None else (pages,))
    tok, lengths, active, remaining, *pt = to_device(arrays, model.device)
    pt = pt[0] if pt else None
    active = active.bool()
    pois = torch.zeros_like(active)
    toks, emitted = [], []
    for _ in range(chunk):
        act = active.int()
        logits, cache = model.forward_serve(
            params, {"tokens": torch.clamp(tok, min=0)[:, None]}, cache,
            lengths, seq_lens=act, pages=pt)
        fin = torch.isfinite(logits).all(dim=-1)
        live = active & fin
        nxt = torch.where(live, torch.argmax(logits, dim=-1).int(), -1)
        new_len = lengths + act
        new_active = live & (nxt != eos) & (remaining > 1) & (new_len < max_len)
        lengths = torch.where(active & ~new_active, 0, new_len)
        remaining = remaining - act
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


# ---------------------------------------------------------------------------
# the scheduler
# ---------------------------------------------------------------------------
class Request:
    """One generation request tracked by the Scheduler.  `status` is
    "queued" -> "done" | "poisoned"."""

    __slots__ = ("rid", "prompt", "max_new_tokens", "tokens", "done",
                 "status")

    def __init__(self, rid: int, prompt: Sequence[int], max_new_tokens: int):
        self.rid = rid
        self.prompt = list(int(t) for t in prompt)
        self.max_new_tokens = int(max_new_tokens)
        self.tokens: List[int] = []
        self.done = False
        self.status = "queued"


class Scheduler:
    """Continuous-batching request scheduler over a slot-based KV cache.

    The cache is `max_batch_slots` independent slots with per-slot lengths.
    `submit` queues requests; every `step`:

      1. admits queued requests into free slots, one bucketed ragged
         prefill per admission wave (FCFS: the queue head waits rather than
         being skipped);
      2. runs one `decode_chunk`-step decode over all slots (idle slots cost
         no kernel compute);
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
    under greedy decoding resumes the same stream.

    Greedy decoding only (see the module docstring); the reference's other
    options raise NotImplementedError."""

    def __init__(self, model: Model, params, *, max_batch_slots: int = 8,
                 max_len: int = 2048, eos_id: Optional[int] = None,
                 temperature: float = 0.0, top_k: int = 0, top_p: float = 1.0,
                 decode_chunk: int = 8, page_size: int = 0,
                 num_pages: int = 0, **not_ported):
        _refuse_unported(not_ported)
        if temperature > 0.0:
            raise NotImplementedError(
                "sampled scheduler streams need the reference's per-(request, "
                "token) threefry keys (ROADMAP.md §1 item 4)")
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
            self.page_ref = np.zeros(self.num_pages, np.int32)
            self.peak_pages_in_use = 0
            self.cache = model.init_cache(
                self.B, self.max_len, page_size=self.page_size,
                num_pages=self.num_pages)
        else:
            self.cache = model.init_cache(self.B, self.max_len, ragged=True)
        self.lengths = np.zeros(self.B, np.int32)      # per-slot kv fill
        self.active = np.zeros(self.B, bool)
        self.remaining = np.zeros(self.B, np.int32)    # token budget left
        self.cur_tok = np.full(self.B, -1, np.int32)   # next decode input
        self.slot_req: List[Optional[Request]] = [None] * self.B
        self.queue: "collections.deque[Request]" = collections.deque()
        self.requests: Dict[int, Request] = {}
        self._next_rid = 0
        # admission stamps: the youngest slot is the eviction victim
        self._admit_seq = np.zeros(self.B, np.int64)
        self._admit_counter = 0
        self._step_idx = 0
        self._queue_depths: List[int] = []
        self.model_steps = 0         # device forwards (a chunk counts each)
        self.n_evictions = 0
        self.n_poisoned = 0

    # -- request intake -----------------------------------------------------
    def submit(self, prompt: Sequence[int], max_new_tokens: int,
               **not_ported) -> int:
        """Queue a request; raises a `SubmitError` for one that can never
        be served."""
        _refuse_unported(not_ported)
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
        r = Request(self._next_rid, prompt, max_new_tokens)
        self._next_rid += 1
        self.requests[r.rid] = r
        self.queue.append(r)
        return r.rid

    def _bucket(self, n: int) -> int:
        b = PREFILL_BUCKET
        while b < n:
            b *= 2
        # never a prefill wider than the cache
        return min(b, self.max_len)

    # -- page allocator (host side; pages are opaque to the device) --------
    def _pages_for(self, tokens: int) -> int:
        return -(-int(tokens) // self.page_size)

    def _alloc_slot(self, slot: int, tokens: int) -> bool:
        """Grow `slot`'s page-table row to cover `tokens` tokens (capped at
        max_len), all or nothing."""
        need = self._pages_for(min(int(tokens), self.max_len))
        row = self.page_table[slot]
        have = int((row >= 0).sum())
        if need - have > len(self.free_pages):
            return False
        for j in range(have, need):
            p = self.free_pages.pop()
            self.page_ref[p] = 1
            row[j] = p
        return True

    def _free_slot_pages(self, slot: int):
        row = self.page_table[slot]
        for p in row[row >= 0]:
            self.page_ref[p] -= 1
            if self.page_ref[p] == 0:
                self.free_pages.append(int(p))
        row[:] = -1

    def pages_in_use(self) -> int:
        """Allocated (non-free, non-trash) pages right now."""
        return (self.num_pages - 1) - len(self.free_pages)

    def _note_peak(self):
        if self.paged:
            self.peak_pages_in_use = max(self.peak_pages_in_use,
                                         self.pages_in_use())

    # -- slot lifecycle -----------------------------------------------------
    def _eviction_victim(self) -> int:
        """The youngest active slot; ties break on the highest request id,
        so eviction is deterministic."""
        slots = np.flatnonzero(self.active)
        return int(max(slots, key=lambda b: (int(self._admit_seq[b]),
                                             self.slot_req[b].rid)))

    def _evict(self, slot: int):
        """Free a starved slot and re-queue its request at the head as a
        continuation: re-admission prefills prompt + tokens so far."""
        r = self.slot_req[slot]
        self.slot_req[slot] = None
        self.active[slot] = False
        self.lengths[slot] = 0
        self.cur_tok[slot] = -1
        if self.paged:
            self._free_slot_pages(slot)
        self.n_evictions += 1
        if r is not None:
            self.queue.appendleft(r)

    def _retire(self, slot: int, status: str = "done"):
        r = self.slot_req[slot]
        if r is not None:
            r.done = True
            r.status = status
        self.slot_req[slot] = None
        self.active[slot] = False
        self.lengths[slot] = 0
        if self.paged:
            self._free_slot_pages(slot)

    def _admit(self, emitted: Dict[int, List[int]]):
        """One admission wave: place queued requests into free slots (in
        paged mode only while the free pages cover each prompt), prefill
        them together and sample their first tokens."""
        free = [i for i in range(self.B) if self.slot_req[i] is None]
        wave = []
        while free and self.queue:
            r = self.queue[0]
            if self.paged and not self._alloc_slot(
                    free[0], len(r.prompt) + len(r.tokens)):
                break                           # FCFS: no skipping ahead
            wave.append((free.pop(0), self.queue.popleft()))
        if not wave:
            return
        prompts = [r.prompt + r.tokens for _, r in wave]
        lens = np.array([len(p) for p in prompts], np.int32)
        toks = np.zeros((len(wave), self._bucket(int(lens.max()))), np.int32)
        for i, p in enumerate(prompts):
            toks[i, :len(p)] = p
        slots = np.array([s for s, _ in wave], np.int32)
        self.model_steps += 1
        if self.paged:
            # sample the peak while the wave's prompt pages are held
            self._note_peak()
            tok0, fin = paged_prefill(self.model, self.params, toks, lens,
                                      self.cache, self.page_table[slots])
        else:
            tok0, fin = ragged_prefill(self.model, self.params, toks, lens,
                                       self.cache, slots)
        for i, (s, r) in enumerate(wave):
            self.slot_req[s] = r
            self._admit_counter += 1
            self._admit_seq[s] = self._admit_counter
            self.lengths[s] = lens[i]
            if not fin[i]:
                # non-finite prompt logits: quarantine just this request
                self.n_poisoned += 1
                self._retire(s, status="poisoned")
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
                    or budget_left <= 1 or int(lens[i]) >= self.max_len):
                self._retire(s)
            else:
                self.active[s] = True

    def _plan_decode_run(self) -> np.ndarray:
        """The active slots that can append `decode_chunk` tokens this step.
        Paged mode allocates pages to cover them (capped at max_len); a
        starved slot stalls, and if nothing can run the youngest active
        slot is evicted until something can.  Dense: every active slot."""
        if not self.paged:
            return self.active.copy()
        while True:
            run = self.active.copy()
            for b in np.flatnonzero(self.active):
                if not self._alloc_slot(int(b), int(self.lengths[b])
                                        + self.decode_chunk):
                    run[b] = False
            if run.any() or not self.active.any():
                break
            self._evict(self._eviction_victim())
        self._note_peak()
        return run

    def _decode(self, emitted: Dict[int, List[int]]):
        if not self.active.any():
            return
        run = self._plan_decode_run()
        if not run.any():
            return
        self.model_steps += self.decode_chunk
        # stalled rows advertise length 0 for the chunk (their writes go to
        # the trash page, attention runs no partition) and keep their state
        tok, lengths, active, remaining, toks, em, pois = ragged_decode(
            self.model, self.params, self.cache, self.cur_tok,
            self.lengths * run, run, self.remaining, self.decode_chunk,
            self.eos_id, self.max_len,
            self.page_table if self.paged else None)
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
                self._retire(b, status="poisoned")
            elif not self.active[b]:
                self._retire(b)

    # -- driving --------------------------------------------------------------
    @torch.inference_mode()
    def step(self) -> Dict[int, List[int]]:
        """One scheduling round: admit, then one decode chunk; returns the
        tokens generated this round by request id."""
        emitted: Dict[int, List[int]] = {}
        self._step_idx += 1
        self._queue_depths.append(len(self.queue))
        self._admit(emitted)
        self._decode(emitted)
        self._note_peak()
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
            "evictions": self.n_evictions,
            "poisoned": self.n_poisoned,
            "kv_bytes_per_token": kv_bytes_per_token(self.model.cfg),
            "queue_depth_p50": float(np.percentile(depths, 50)),
            "queue_depth_p95": float(np.percentile(depths, 95)),
        }

    def audit(self):
        """Check the slot and page-accounting invariants; raises
        `AuditError` listing every violation.  Paged: each page's refcount
        equals the table entries holding it, refcount 0 iff on the free
        list, no page twice on the free list, the trash page never handed
        out, table rows contiguous and covering their slot's fill."""
        errs: List[str] = []
        for b in range(self.B):
            if self.slot_req[b] is None and self.active[b]:
                errs.append(f"slot {b}: active without a request")
        if self.paged:
            P = self.num_pages
            free_set = set(self.free_pages)
            if len(free_set) != len(self.free_pages):
                errs.append("free list holds duplicate pages (double-free)")
            if TRASH_PAGE in free_set:
                errs.append("reserved trash page is on the free list")
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
                if (self.slot_req[b] is not None
                        and k < self._pages_for(int(self.lengths[b]))):
                    errs.append(f"slot {b}: kv fill {int(self.lengths[b])} "
                                f"not covered by its {k} pages")
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
             generator: Optional[torch.Generator] = None,
             continuous_batching: bool = False,
             eos_id: Optional[int] = None, decode_chunk: int = 8,
             max_batch_slots: Optional[int] = None, page_size: int = 0,
             num_pages: int = 0, **not_ported) -> torch.Tensor:
    """Batched generation; returns (B, max_new_tokens) token ids.

    Default: equal-length prefill, then one decode step per further token;
    greedy at temperature 0, else sampled with `generator` (default: seeded
    with 0 on the model's device).  With `continuous_batching=True` it is
    one greedy `Scheduler` run over `max_batch_slots` slots (default: the
    batch size), retiring rows at `eos_id` and padding them with it (or 0);
    `page_size > 0` puts the slots on the paged pool of `num_pages` pages."""
    _refuse_unported(not_ported)
    tokens = torch.as_tensor(prompt_batch["tokens"])
    B, S = tokens.shape
    if continuous_batching:
        sched = Scheduler(model, params, max_batch_slots=max_batch_slots or B,
                          max_len=max_len, eos_id=eos_id,
                          temperature=temperature, top_k=top_k, top_p=top_p,
                          decode_chunk=decode_chunk, page_size=page_size,
                          num_pages=num_pages)
        rows = tokens.cpu().numpy()
        rids = [sched.submit(rows[b].tolist(), max_new_tokens) for b in range(B)]
        results = sched.run()
        out = np.full((B, max_new_tokens), 0 if eos_id is None else int(eos_id),
                      np.int64)
        for b, rid in enumerate(rids):
            got = results.get(rid, [])[:max_new_tokens]
            out[b, :len(got)] = got
        return torch.from_numpy(out).to(model.device)
    if page_size:
        raise ValueError("page_size requires continuous_batching=True")
    tokens = tokens.to(model.device)
    if S + max_new_tokens > max_len + 1:
        raise ValueError(f"prompt {S} + {max_new_tokens} new tokens do not fit "
                         f"a cache of {max_len}")
    if generator is None and temperature > 0.0:
        generator = torch.Generator(device=model.device).manual_seed(0)
    cache = model.init_cache(B, max_len)
    with torch.inference_mode():
        logits, cache = model.forward_serve(params, {"tokens": tokens}, cache, 0)
        tok = sample_logits(logits, generator, temperature, top_k, top_p)
        out = [tok]
        for t in range(max_new_tokens - 1):
            logits, cache = model.forward_serve(
                params, {"tokens": tok[:, None]}, cache, S + t)
            tok = sample_logits(logits, generator, temperature, top_k, top_p)
            out.append(tok)
    return torch.stack(out, dim=1)


def greedy_generate(model: Model, params, prompt_batch, max_new_tokens: int,
                    max_len: int) -> torch.Tensor:
    """Batched greedy decoding (temperature 0 `generate`)."""
    return generate(model, params, prompt_batch, max_new_tokens, max_len)
