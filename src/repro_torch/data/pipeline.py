"""Deterministic synthetic LM batches (numpy), a copy of the JAX package's
`data/pipeline.py::lm_batch`: a fixed random Markov chain over the vocab,
counter-based so that row r / time t depend only on (seed, step, r, t)."""
from __future__ import annotations

import functools
from typing import Optional

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
