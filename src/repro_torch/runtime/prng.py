"""Threefry2x32 keys and draws in torch integer arithmetic, equal bit for
bit to `jax.random` with `jax_threefry_partitionable` on (JAX 0.9's
default).

The JAX package draws with library code that none of its own files holds;
this module reproduces, from JAX 0.9.0:

  * `jax/_src/prng.py`: `threefry_seed` (:802), `threefry_2x32` (:1092),
    `_threefry_split_foldlike` (:1156), `_threefry_fold_in` (:1168) and
    `_threefry_random_bits_partitionable` (:1184);
  * `jax/_src/random.py`: `_uniform` (:435), `_gumbel` (:1723, mode
    "low") and `categorical` (:1739).

A key is a (..., 2) tensor of 32-bit words held in int64 and masked to 32
bits, so that adds, rotations and logical shifts behave alike on the CPU
and on CUDA (torch's uint32 has no CUDA arithmetic).  Every function
takes a batch of keys in the leading dims and vectorises over it, as the
reference vmaps: `random_bits32(keys (B, 2), (V,))` hashes a (B, V) grid
in one chain of elementwise ops.

With the partitionable scheme, split and random bits hash the flat index
of each element (`iota_2x32_shape`: high and low words of a 64-bit
counter), and a 32-bit draw is the xor of the hash's two output words.
Keys, bits and uniforms are exact; `gumbel` applies torch's `log`, which
may differ from XLA's by an ulp.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA

Shape = Union[int, Sequence[int]]


def _u32(x: torch.Tensor) -> torch.Tensor:
    return x & _MASK


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor,
                 x2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 block cipher, 20 rounds (JAX's
    `_threefry2x32_lowering`), on broadcastable int64 words < 2^32."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x = [_u32(x1 + ks[0]), _u32(x2 + ks[1])]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = _u32(x[0] + x[1])
            x[1] = x[0] ^ _rotl(x[1], r)
        x[0] = _u32(x[0] + ks[(i + 1) % 3])
        x[1] = _u32(x[1] + ks[(i + 2) % 3] + (i + 1))
    return x[0], x[1]


def _shape(shape: Shape) -> Tuple[int, ...]:
    return (int(shape),) if isinstance(shape, int) else tuple(int(s) for s in shape)


def _words(key: torch.Tensor, n_dims: int):
    """A key batch's two words, shaped to broadcast over `n_dims`
    trailing dims."""
    key = torch.as_tensor(key)
    tail = (1,) * n_dims
    return (key[..., 0].reshape(key.shape[:-1] + tail),
            key[..., 1].reshape(key.shape[:-1] + tail))


def _counts(shape: Tuple[int, ...], device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(high, low) 32-bit words of each element's flat C-order index
    (JAX's `iota_2x32_shape`)."""
    flat = torch.arange(math.prod(shape), dtype=torch.int64,
                        device=device).reshape(shape)
    return flat >> 32, flat & _MASK


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """`jax.random.PRNGKey(seed)` with JAX's default 32-bit types: the (2,)
    key [0, seed mod 2^32] (a negative seed in two's complement, a seed
    past 32 bits cut to its low word, as JAX's conversion does)."""
    return torch.tensor([0, int(seed) & _MASK], dtype=torch.int64,
                        device=device)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """`jax.random.fold_in`: key batch (..., 2) and data broadcastable to
    its batch (an int, or an integer tensor taken modulo 2^32, as JAX's
    conversion to uint32) -> (..., 2)."""
    key = torch.as_tensor(key)
    data = _u32(torch.as_tensor(data, device=key.device).to(torch.int64))
    k1, k2 = key[..., 0], key[..., 1]
    y1, y2 = threefry2x32(k1, k2, torch.zeros_like(data), data)
    y1, y2 = torch.broadcast_tensors(y1, y2)
    return torch.stack([y1, y2], dim=-1)


def split(key: torch.Tensor, num: Shape = 2) -> torch.Tensor:
    """`jax.random.split`: key batch (..., 2) -> (..., *num, 2)."""
    shape = _shape(num)
    k1, k2 = _words(key, len(shape))
    c1, c2 = _counts(shape, k1.device)
    y1, y2 = threefry2x32(k1, k2, c1, c2)
    return torch.stack(torch.broadcast_tensors(y1, y2), dim=-1)


def random_bits32(key: torch.Tensor, shape: Shape = ()) -> torch.Tensor:
    """`jax.random.bits(key, shape, uint32)`: key batch (..., 2) ->
    (..., *shape) int64 words < 2^32."""
    shape = _shape(shape)
    k1, k2 = _words(key, len(shape))
    c1, c2 = _counts(shape, k1.device)
    y1, y2 = threefry2x32(k1, k2, c1, c2)
    return y1 ^ y2


def uniform(key: torch.Tensor, shape: Shape = (), minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """`jax.random.uniform` in float32, key batch (..., 2) -> (..., *shape):
    the top 23 bits as a mantissa of [1, 2), minus 1, scaled to
    [minval, maxval) and floored at minval.  XLA fuses the scaling into
    one multiply-add, rounded once; float64 holds the product exactly, so
    it is rounded once here too."""
    bits = random_bits32(key, shape)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=f.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=f.device)
    scaled = (f.double() * (hi - lo).double() + lo.double()).float()
    return torch.maximum(lo, scaled)


def gumbel(key: torch.Tensor, shape: Shape = ()) -> torch.Tensor:
    """`jax.random.gumbel` (mode "low") in float32: -log(-log(u)) with u
    uniform in [tiny, 1)."""
    u = uniform(key, shape, torch.finfo(torch.float32).tiny, 1.0)
    return -torch.log(-torch.log(u))


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """`jax.random.categorical` over the last axis: argmax(gumbel + logits).
    A key batch (*K, 2) draws each of the logits' leading K dims with its
    own key (as the reference's vmap), the Gumbel noise of the remaining
    dims hashed by their flat index; a single (2,) key noises all of
    `logits` at once (one key for a (B, V) batch)."""
    key = torch.as_tensor(key)
    rest = logits.shape[key.dim() - 1:]
    noise = gumbel(key.to(logits.device), rest)
    return torch.argmax(noise + logits, dim=-1)
