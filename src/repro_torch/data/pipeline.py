"""Deterministic synthetic batches (numpy), a copy of the JAX package's
`data/pipeline.py`: `lm_batch`, a fixed random Markov chain over the vocab,
counter-based so that row r / time t depend only on (seed, step, r, t);
`copy_batch`, a random prefix repeated; `make_batch`, a step's whole batch
with the modality stubs (encoder frames, image patch embeddings)."""
from __future__ import annotations

import functools
from typing import Dict, Optional

import numpy as np


@functools.lru_cache(maxsize=8)
def _markov_table(vocab: int, seed: int, branching: int = 4) -> np.ndarray:
    """(vocab, branching) int32 successor table."""
    rng = np.random.RandomState(seed ^ 0x5EED)
    table = rng.randint(0, vocab, size=(vocab, branching)).astype(np.int32)
    table.setflags(write=False)
    return table


def _hash_mix(x: np.ndarray) -> np.ndarray:
    """Counter-based integer hash (splitmix-style)."""
    x = x.astype(np.uint64)
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))


def lm_batch(step: int, batch: int, seq: int, vocab: int, seed: int = 0,
             start: int = 0, count: Optional[int] = None) -> np.ndarray:
    """Rows [start, start + count) of the global (batch, seq) int32 token
    batch of `step`."""
    count = batch if count is None else count
    table = _markov_table(vocab, seed)
    branching = table.shape[1]
    r_idx = np.arange(start, start + count, dtype=np.uint64)[:, None]
    t_idx = np.arange(seq, dtype=np.uint64)[None, :]
    base = np.uint64(seed) * np.uint64(0x9E3779B97F4A7C15) \
        + np.uint64(step) * np.uint64(0xD1B54A32D192ED03)
    choices = (_hash_mix(base + r_idx * np.uint64(1_000_003) + t_idx)
               % np.uint64(branching)).astype(np.int64)
    states = (_hash_mix(base ^ _hash_mix(r_idx[:, 0] + np.uint64(17)))
              % np.uint64(vocab)).astype(np.int64)
    out = np.empty((count, seq), np.int32)
    s = states.copy()
    for t in range(seq):
        out[:, t] = s
        s = table[s, choices[:, t]]
    return out


def copy_batch(step: int, batch: int, seq: int, vocab: int, seed: int = 0
               ) -> np.ndarray:
    """A random prefix of seq // 2 tokens in [2, vocab), then the prefix
    repeated up to seq tokens."""
    rng = np.random.RandomState((seed * 31 + step) % (2**31))
    half = seq // 2
    prefix = rng.randint(2, vocab, size=(batch, half)).astype(np.int32)
    return np.concatenate([prefix, prefix[:, : seq - half]], axis=1)


def make_batch(cfg, shape, step: int, seed: int = 0, kind: str = "lm"
               ) -> Dict[str, np.ndarray]:
    """The whole numpy batch of one step: (B, S) int32 "tokens" (B, S =
    `shape.global_batch`, `shape.seq_len`) from `lm_batch` or, with kind
    "copy", `copy_batch`; then, from one RandomState of (seed, step),
    float32 "frames" (B, encoder_seq_len, d_model) for an encoder-decoder
    config and "image_embeds" (B, num_image_patches, d_model) for a config
    with image patches."""
    B, S = shape.global_batch, shape.seq_len
    fn = lm_batch if kind == "lm" else copy_batch
    batch = {"tokens": fn(step, B, S, cfg.vocab_size, seed)}
    rng = np.random.RandomState((seed * 17 + step) % (2**31))
    if cfg.is_encoder_decoder:
        batch["frames"] = rng.randn(
            B, cfg.encoder_seq_len, cfg.d_model).astype(np.float32)
    if cfg.num_image_patches:
        batch["image_embeds"] = rng.randn(
            B, cfg.num_image_patches, cfg.d_model).astype(np.float32)
    return batch
