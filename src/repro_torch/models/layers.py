"""Shared model layers: norms, embeddings, RoPE, sinusoidal positions, the
MLP (through PIM linears) and the row-local sums and softplus of the
recurrent blocks.  Counterpart of the JAX package's
`models/layers.py`; parameters are plain dicts of tensors in the same tree
layout."""
from __future__ import annotations

import ctypes
import ctypes.util
import functools
import math

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import pim


def pairwise_row_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last dim (keepdim) in a fixed order: the row is halved
    by elementwise adds until one column is left (an odd column joins
    column 0).  Elementwise ops round each element alone, so a row's sum
    never depends on the other rows of `x`."""
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        head = x[..., :h] + x[..., h:2 * h]
        x = head if x.shape[-1] % 2 == 0 else torch.cat(
            [head[..., :1] + x[..., 2 * h:], head[..., 1:]], dim=-1)
    return x


def row_mean(x: torch.Tensor) -> torch.Tensor:
    """Mean over the last dim (keepdim), whose bits do not depend on the
    other rows of `x`.  On the card torch's reduction splits a row
    differently with the number of rows, so a row normalized in a decode
    step (8 rows) and in a mixed step (thousands) could round differently
    and a served stream would depend on what it is batched with; there the
    row is summed by `pairwise_row_sum`.  The CPU keeps torch's mean, which
    equals the reference's eager one bit for bit."""
    if not x.is_cuda:
        return x.mean(dim=-1, keepdim=True)
    return pairwise_row_sum(x) / x.shape[-1]


SCAN_BLOCK = 16


def _sequential_cumsum(x: torch.Tensor) -> torch.Tensor:
    out = x.clone()
    for k in range(1, x.shape[-1]):
        out[..., k] += out[..., k - 1]
    return out


def blocked_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive float sum over the last dim in the order of XLA's
    reduce-window rewrite of `jnp.cumsum` on the CPU: blocks of 16 summed
    in sequence, their totals scanned the same way recursively and added
    in.  Equal bit for bit to the reference's cumsum, and made of
    elementwise ops, so a row's sums never depend on the rows beside it
    (on CUDA torch.cumsum scans a lone row with another algorithm).  The
    sampler's nucleus sums and the mLSTM's forget-gate sums run on it."""
    n = x.shape[-1]
    if n <= SCAN_BLOCK:
        return _sequential_cumsum(x)
    nb = -(-n // SCAN_BLOCK)
    xp = torch.nn.functional.pad(x, (0, nb * SCAN_BLOCK - n))
    within = _sequential_cumsum(xp.view(*x.shape[:-1], nb, SCAN_BLOCK))
    before = torch.nn.functional.pad(blocked_cumsum(within[..., -1])[..., :-1],
                                     (1, 0))
    return (within + before[..., None]).view(*x.shape[:-1], -1)[..., :n]


def softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x) as the reference's `jax.nn.softplus` computes it,
    `logaddexp(x, 0)`: max(x, 0) + log1p(exp(-|x|)), op by op in x's
    dtype.  torch's `F.softplus` returns x itself past a threshold of 20
    and computes log1p(exp(x)) below it, another order of float ops."""
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-x.abs()))


def norm_apply(params, x: torch.Tensor, kind: str,
               eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    if kind == "layernorm":
        mu = row_mean(xf)
        var = row_mean((xf - mu) ** 2)
        y = (xf - mu) * torch.rsqrt(var + eps)
        y = y * params["scale"] + params["bias"]
    else:  # rmsnorm
        ms = row_mean(xf * xf)
        y = xf * torch.rsqrt(ms + eps) * params["scale"]
    return y.to(x.dtype)


def embed_apply(params, tokens: torch.Tensor, dtype) -> torch.Tensor:
    """Rows of the table cast to `dtype`.  The table is cast first, as the
    reference casts it, so that a training step sums the gradient of a
    repeated token in `dtype` as the reference's does (a served table is
    already in the compute dtype: no copy)."""
    return params["table"].to(dtype)[tokens]


UNEMBED_ROWS = 64


def unembed_apply(params, x: torch.Tensor) -> torch.Tensor:
    """Logits against the (V, D) head table, in the dtype of x.  On the
    card cuBLAS picks its kernel, and so a row's order of sums, by the
    number of rows (in float32 a row's logits change between 3 and 15
    rows), so a verify column's logits could differ from those of the
    single-token step it replaces; there the rows run through products of
    exactly UNEMBED_ROWS rows, the last one padded with zeros.  The CPU
    keeps one product."""
    w = params["table"].to(x.dtype).t()
    if not x.is_cuda:
        return x @ w
    rows = x.reshape(-1, x.shape[-1])
    n = rows.shape[0]
    rows = torch.nn.functional.pad(rows, (0, 0, 0, -n % UNEMBED_ROWS))
    out = torch.cat([rows[i:i + UNEMBED_ROWS] @ w
                     for i in range(0, rows.shape[0], UNEMBED_ROWS)])
    return out[:n].reshape(*x.shape[:-1], w.shape[1])


def rope_apply(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, S, H, Dh); positions: (S,) or (B, S)."""
    half = x.shape[-1] // 2
    freqs = torch.pow(theta, -torch.arange(half, dtype=torch.float32,
                                           device=x.device) / half)
    ang = positions.float()[..., None] * freqs
    ang = ang[None, :, None, :] if positions.dim() == 1 else ang[:, :, None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    y = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return y.to(x.dtype)


# The f32 constants of XLA's CPU exp (clamp bounds, log2(e), ln 2 in two
# parts, the polynomial's coefficients from the cubic term up)
_EXP_LO, _EXP_HI = np.float32(-87.8), np.float32(88.8)
_LOG2E, _LN2_HI, _LN2_LO = np.float32(1.44269502), np.float32(0.693359375), \
    np.float32(-2.12194442e-4)
_EXP_POLY = tuple(np.float32(c) for c in (
    1.98756912e-4, 1.39819994e-3, 8.33345205e-3, 4.16657962e-2, 1.66666657e-1,
    0.5))


def _fma(a, b, c) -> np.ndarray:
    """a * b + c on float32 values, rounded once (the product is exact in
    float64, the sum rounded to float64 and then to float32)."""
    f = np.float64
    return (np.asarray(a, f) * np.asarray(b, f) + np.asarray(c, f)
            ).astype(np.float32)


def _xla_exp(x: np.ndarray) -> np.ndarray:
    """exp of float32 x as the reference's XLA computes it on an x86-64
    CPU: 2^m * p(r), r = x - m ln 2 (m = floor(x log2 e + 1/2)), the
    polynomial by fused multiply-adds, subnormal results flushed to 0.
    torch's and numpy's exp differ from it by an ulp now and then (21 of
    whisper-tiny's 192 inverse frequencies)."""
    x = np.clip(np.asarray(x, np.float32), _EXP_LO, _EXP_HI)
    m = np.clip(np.floor(_fma(x, _LOG2E, 0.5)), -127, 127).astype(np.float32)
    r = _fma(-m, _LN2_LO, _fma(-m, _LN2_HI, x))
    p = _EXP_POLY[0]
    for c in _EXP_POLY[1:]:
        p = _fma(p, r, c)
    p = _fma(p, r * r, r) + np.float32(1.0)
    y = p * ((m.astype(np.int32) + 127) << 23).view(np.float32)
    return np.where(np.abs(y) < np.finfo(np.float32).tiny, np.float32(0), y)


@functools.lru_cache(maxsize=None)
def _libm_f32(name: str):
    """The C library's float32 `sinf` / `cosf`, which the reference's XLA
    calls for sin and cos on the CPU (torch's and numpy's differ from them
    in 2-13 % of whisper-tiny's table); a numpy ufunc."""
    fn = getattr(ctypes.CDLL(ctypes.util.find_library("m")), name)
    fn.restype, fn.argtypes = ctypes.c_float, [ctypes.c_float]
    return np.frompyfunc(fn, 1, 1)


@functools.lru_cache(maxsize=8)
def _sinusoid_table(seq: int, d: int) -> np.ndarray:
    pos = np.arange(seq, dtype=np.float32)[:, None]
    step = np.log(np.float32(10000.0)) * np.float32(-1.0) / np.float32(d)
    arg = pos * _xla_exp(np.arange(0, d, 2, dtype=np.float32) * step)
    pe = np.zeros((seq, d), np.float32)
    pe[:, 0::2] = _libm_f32("sinf")(arg).astype(np.float32)
    pe[:, 1::2] = _libm_f32("cosf")(arg).astype(np.float32)
    pe.flags.writeable = False
    return pe


def sinusoidal_positions(seq: int, d: int, device=None) -> torch.Tensor:
    """The (seq, d) float32 sinusoid table of the reference's encoder:
    sin(p w_i) at even columns and cos(p w_i) at odd ones, w_i =
    exp(-2i ln(10^4) / d), bit for bit the reference's on the CPU (its
    exp, sinf and cosf, `_xla_exp` and `_libm_f32`).  Built once per
    shape on the host (about 0.2 s at whisper-tiny's 1,500 x 384), then
    copied to `device`."""
    return torch.from_numpy(_sinusoid_table(seq, d).copy()).to(device)


_SQRT_2_OVER_PI = math.sqrt(2.0 / math.pi)


@functools.lru_cache(maxsize=None)
def _rounded(v: float, dtype: torch.dtype) -> float:
    """The Python float `v` rounded to `dtype`."""
    return torch.tensor(v, dtype=dtype).item()


def gelu(x: torch.Tensor) -> torch.Tensor:
    """The reference's tanh-form GELU, x * 0.5 * (1 + tanh(sqrt(2 / pi) *
    (x + 0.044715 * x^3))), op by op with every constant first made a
    value of x's dtype, as the reference rounds its constants: in bfloat16
    bit for bit.  torch's fused `gelu(approximate="tanh")` rounds once at
    its end instead, and differs in about 43% of bf16 outputs.  In float32
    only tanh itself can differ from the reference's (an ulp).  The
    constants are host scalars (a scalar operand's product or sum is
    rounded to x's dtype like a tensor's), so no call copies to the card."""
    def c(v):
        return _rounded(v, x.dtype)

    inner = c(_SQRT_2_OVER_PI) * (x + c(0.044715) * x ** 3)
    return x * (c(0.5) * (c(1.0) + torch.tanh(inner)))


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """1 / (1 + exp(-x)), each op rounded to x's dtype: the reference's
    sigmoid, bit for bit in bfloat16."""
    return torch.reciprocal(1 + torch.exp(-x))


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * sigmoid(x)


def _act(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind in ("silu", "swiglu"):
        return silu(x)
    if kind in ("gelu", "geglu"):
        return gelu(x)
    if kind == "relu_sq":
        return torch.square(torch.relu(x))
    raise ValueError(kind)


def mlp_apply(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    p, en = cfg.pim, cfg.pim_linears
    if "w_gate" in params:
        g = pim.pim_linear_apply(params["w_gate"], x, p, en)
        h = pim.pim_linear_apply(params["w_in"], x, p, en)
        h = _act(g, cfg.activation) * h
    else:
        h = _act(pim.pim_linear_apply(params["w_in"], x, p, en), cfg.activation)
    return pim.pim_linear_apply(params["w_out"], h, p, en)
