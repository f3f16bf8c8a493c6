"""Batched generation over the PIM KV cache: the classic equal-length path.

Counterpart of the JAX package's `runtime/serve_lib.py` (`sample_logits`,
`_truncate_logits`, `generate`, `greedy_generate`).  One prefill over the
prompts, then a Python loop of single-token decode steps that update the
preallocated cache in place.  The reference fuses that loop into one
`lax.scan`; capturing it in a CUDA graph is later work.  Continuous
batching (the slot scheduler) is a later slice and raises here.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.models.model_zoo import Model


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


def generate(model: Model, params, prompt_batch: Dict[str, torch.Tensor],
             max_new_tokens: int, max_len: int, temperature: float = 0.0,
             top_k: int = 0, top_p: float = 1.0,
             generator: Optional[torch.Generator] = None,
             continuous_batching: bool = False) -> torch.Tensor:
    """Batched generation; returns (B, max_new_tokens) token ids.

    Equal-length prefill, then one decode step per further token.  With
    temperature 0 this is greedy decoding; otherwise tokens are sampled
    with `generator` (default: seeded with 0 on the model's device)."""
    if continuous_batching:
        raise NotImplementedError(
            "continuous batching waits for the port of the scheduler")
    tokens = torch.as_tensor(prompt_batch["tokens"]).to(model.device)
    B, S = tokens.shape
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
