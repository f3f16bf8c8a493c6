"""Macro-tiled PIM matmul: the CUDA kernel's wrapper and its plain PyTorch
version.

Counterpart of the JAX package's `kernels/pim_matmul.py`
(`pim_matmul_int_pallas`).  The kernel is `csrc/pim_matmul.cu`; its header
says what it computes, what bounds it on the card and how.

`pim_matmul_int` launches the kernel for CUDA tensors and runs
`pim_matmul_int_plain` for CPU tensors, never one in place of the other.
Both take one product, (M, K) x (K, N), or a stack of E of them, (E, M, K)
x (E, K, N) -> (E, M, N): the experts of a MoE layer in one launch, each
computed exactly as its own (M, K) x (K, N) call.
Both sum the ADC codes of the 16-row groups as integers and multiply by the
ADC step once, so they agree bit for bit at every K; the reference's float32
sum of code * step equals theirs wherever that sum is exact.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.configs.base import PIMConfig
from repro_torch.core import quant
from repro_torch.kernels import _build

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_long, ctypes.c_float
_SIGNATURES = {
    "pim_matmul_launch": [_P] * 6 + [_I] * 5 + [_L] * 5 + [_I] * 5 + [_F] * 5
                         + [_P],
}
_BN, _BK = 128, 64         # N rows of an output tile; K rows of a stage
PSUM_MAX = 16 * 128 * 128  # largest |partial sum| of a 16-row int8 group
_MAGIC = 12582912.0        # 1.5 * 2^23: float32 integers have ulp 1 above it
# float64 partial sums the plain version holds at once (512 MB)
_PLAIN_CHUNK = 1 << 26


def _check(x_q: torch.Tensor, w_q: torch.Tensor) -> None:
    if (x_q.dim() not in (2, 3) or w_q.dim() != x_q.dim()
            or x_q.shape[-1] != w_q.shape[-2] or x_q.shape[:-2] != w_q.shape[:-2]):
        raise ValueError(f"pim_matmul takes (M, K) x (K, N) or (E, M, K) x "
                         f"(E, K, N), got {tuple(x_q.shape)} x {tuple(w_q.shape)}")
    if x_q.dtype != torch.int8 or w_q.dtype != torch.int8:
        raise ValueError("pim_matmul takes int8 operands")
    if x_q.device != w_q.device:
        raise ValueError(f"operands on {x_q.device} and {w_q.device}")


def pim_matmul_int(x_q: torch.Tensor, w_q: torch.Tensor,
                   cfg: PIMConfig = PIMConfig()) -> torch.Tensor:
    """(M, K) int8 x (K, N) int8 -> (M, N) float32 on the accumulation grid:
    exact int32 sums (ideal) or summed ADC codes times the step (quantized).
    With a leading expert axis, (E, M, K) x (E, K, N) -> (E, M, N) in one
    launch.  `w_q` is read as stored, at its offset and strides (one of its
    last two strides 1)."""
    _check(x_q, w_q)
    if x_q.is_cuda:
        return _launch(x_q, w_q, cfg)
    if x_q.device.type != "cpu":
        raise ValueError(f"no pim_matmul kernel for {x_q.device}")
    return pim_matmul_int_plain(x_q, w_q, cfg)


def pim_matmul_int_plain(x_q: torch.Tensor, w_q: torch.Tensor,
                         cfg: PIMConfig = PIMConfig()) -> torch.Tensor:
    """The plain PyTorch version of `pim_matmul_int`, on any device.  The
    products are float64, exact for every int8 dot (|sum| < 2^53): CUDA has
    no integer matmul."""
    _check(x_q, w_q)
    if x_q.dim() == 2:
        return _plain_stack(x_q[None], w_q[None], cfg)[0]
    return _plain_stack(x_q, w_q, cfg)


def _plain_stack(x_q: torch.Tensor, w_q: torch.Tensor,
                 cfg: PIMConfig) -> torch.Tensor:
    """(E, M, K) x (E, K, N), expert by expert: an expert's word-line
    groups through batched products, a chunk of groups at a time."""
    E, M, K = x_q.shape
    N = w_q.shape[-1]
    if cfg.adc_mode == "ideal":
        return torch.bmm(x_q.double(), w_q.double()).float()
    g = cfg.wordline_group
    pad = (-K) % g
    f = torch.nn.functional
    G = (K + pad) // g
    # (E * G, M, g) and (E * G, g, N): one (expert, word-line group) a row
    xg = f.pad(x_q, (0, pad)).view(E, M, G, g).transpose(1, 2).reshape(E * G, M, g)
    wg = f.pad(w_q.transpose(1, 2), (0, pad)).transpose(1, 2).reshape(E * G, g, N)
    codes = torch.zeros((E, M, N), dtype=torch.int32, device=x_q.device)
    per = max(1, _PLAIN_CHUNK // max(1, M * N))
    for e in range(E):
        for lo in range(e * G, (e + 1) * G, per):
            hi = min(lo + per, (e + 1) * G)
            # (groups, M, N) partial sums, one per word-line group
            psum = torch.bmm(xg[lo:hi].double(), wg[lo:hi].double())
            code = quant.adc_code(psum, cfg.adc_bits, quant.adc_full_range(cfg))
            codes[e] += code.to(torch.int32).sum(dim=0, dtype=torch.int32)
    step = torch.full((), quant.adc_step(cfg), device=x_q.device)
    return codes.float() * step


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def tile_m(M: int) -> int:
    """Rows of M in one output tile of the kernel (every tile has 128 of
    N): 8 or 16 at decode, where the weights are the MMA's A operand and
    the tokens its n8 B operand, else 64."""
    return 8 if M <= 8 else 16 if M <= 16 else 64


def split_k(M: int, N: int, K: int, sms: int, experts: int = 1):
    """(splits, K rows per split): K is cut into 64-row-aligned ranges of
    at least 256 rows until the grid has about two CTAs per SM (decode's few
    rows, and prefill at small N, leave few output tiles).  The tiles of
    every expert count: a split grid has at most one tile per SM."""
    tiles = experts * -(-N // _BN) * -(-M // tile_m(M))
    want = max(1, min(2 * sms // tiles, -(-K // (4 * _BK))))
    k_split = -(-(-(-K // want)) // _BK) * _BK
    return -(-K // k_split), k_split


def _f32(v) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32)


def _psum_codes(cfg: PIMConfig):
    """(p, code(p)): every partial sum a 16-row group of int8 products can
    reach, in order, and its ADC code by `quant.adc_code`."""
    p = torch.arange(-PSUM_MAX, PSUM_MAX + 1, dtype=torch.int32)
    return p, quant.adc_code(p, cfg.adc_bits, quant.adc_full_range(cfg)).to(torch.int32)


@functools.lru_cache(maxsize=None)
def adc_thresholds(cfg: PIMConfig) -> torch.Tensor:
    """T[c] = min{p : code(p) >= c} for c = lo + 1 .. hi (2^adc_bits - 1 of
    them; 2^31 - 1 where no partial sum reaches c), so that
    code(p) = lo + #{c : T[c] <= p}."""
    half = 1 << (cfg.adc_bits - 1)
    p, codes = _psum_codes(cfg)
    if not bool((codes[1:] >= codes[:-1]).all()):
        raise ValueError(f"ADC codes not monotone in the partial sum for {cfg}")
    first = torch.searchsorted(codes, torch.arange(-half + 1, half, dtype=torch.int32))
    out = torch.full(first.shape, 2 ** 31 - 1, dtype=torch.int32)
    reached = first < p.numel()
    out[reached] = p[first[reached]]
    return out


def _adc_constants(cfg: PIMConfig):
    """(a, b, w, c) of the kernel's guess, each a float32 value:
    sat(pm * a + b) * w + c = 1.5 * 2^23 + p / step - 1/4, for
    pm = 1.5 * 2^23 + p, clipped to [lo, hi]."""
    w = float((1 << cfg.adc_bits) - 1)
    lo = -(1 << (cfg.adc_bits - 1))
    inv = 1.0 / float(_f32(quant.adc_step(cfg)))
    return (float(_f32(inv / w)), float(_f32(-(_MAGIC * inv + lo + 0.25) / w)),
            w, _MAGIC + lo)


def _kernel_table(cfg: PIMConfig) -> torch.Tensor:
    """(2^adc_bits,) float32: for the guess g = lo + j, 1.5 * 2^23 +
    T[g + 1] - 1, and +inf for g = hi."""
    t = adc_thresholds(cfg).double()
    return torch.cat([_MAGIC + t - 1.0, torch.tensor([float("inf")])]).float()


def _fma_f32(x: torch.Tensor, y: float, z: float) -> torch.Tensor:
    """fmaf(x, y, z) of float32 x and float32 values y, z, rounded once: the
    product is exact in float64 (24 + 24 bits), the sum's float64 rounding
    error is recovered exactly (TwoSum), and a float64 result that sits on a
    float32 tie is moved the way that error points."""
    prod = x.double() * y
    r = prod + z
    bb = r - prod
    err = (prod - (r - bb)) + (z - bb)
    out = r.float()
    f = out.double()
    # r's other float32 neighbour; a tie is r halfway between the two
    nb = torch.where(r > f, torch.nextafter(out, _f32(float("inf"))),
                     torch.nextafter(out, _f32(float("-inf"))))
    tie = (err != 0) & ((f + nb.double()) / 2 == r)
    return torch.where(tie, torch.where(err > 0, torch.maximum(out, nb),
                                        torch.minimum(out, nb)), out)


def adc_kernel_codes(psum: torch.Tensor, cfg: PIMConfig) -> torch.Tensor:
    """The kernel's ADC on int32 partial sums (|p| <= 2^18), in the kernel's
    float32 operations: with pm = 1.5 * 2^23 + p, the guess
    1.5 * 2^23 + g = fl(fl(w * sat(fl(pm * a + b))) + c), then the code
    g + (pm >= table[g - lo] + 1)."""
    a, b, w, c = _adc_constants(cfg)
    table = _kernel_table(cfg)
    pm = (psum + int(_MAGIC)).float()
    s = _fma_f32(pm, a, b).clamp(0.0, 1.0)
    gm = _fma_f32(s, w, c)
    g = gm.view(torch.int32) - _f32(_MAGIC).view(torch.int32)
    up = (pm - table[(gm.view(torch.int32) - _f32(c).view(torch.int32)).long()])
    return g + up.clamp(0.0, 1.0).to(torch.int32)


@functools.lru_cache(maxsize=None)
def adc_table(cfg: PIMConfig):
    """(table, (a, b, w, c)) of the kernel's division-free ADC, after
    checking that `adc_kernel_codes` equals `quant.adc_code` on every
    partial sum in [-2^18, 2^18]; raises for a configuration where it does
    not."""
    p, codes = _psum_codes(cfg)
    if not torch.equal(adc_kernel_codes(p, cfg), codes):
        raise ValueError(f"the kernel's ADC guess misses a code for {cfg}")
    return _kernel_table(cfg), _adc_constants(cfg)


@functools.lru_cache(maxsize=None)
def _device_table(cfg: PIMConfig, dev: torch.device) -> torch.Tensor:
    return adc_table(cfg)[0].to(dev)


@functools.lru_cache(maxsize=None)
def _tile_counters(dev: torch.device) -> torch.Tensor:
    """A zeroed int32 per output tile of a split launch, which the kernel
    leaves zeroed (`split_k` splits only grids of at most one tile per SM,
    the tiles of every expert counted).
    Launches on one stream at a time share them."""
    return torch.zeros(_sm_count(dev.index or 0), dtype=torch.int32, device=dev)


def _lib():
    return _build.load("pim_matmul", _SIGNATURES)


def _launch(x_q: torch.Tensor, w_q: torch.Tensor, cfg: PIMConfig):
    stacked = x_q.dim() == 3
    if not stacked:
        x_q, w_q = x_q[None], w_q[None]
    E, M, K = x_q.shape
    N = w_q.shape[-1]
    dev = x_q.device
    if cfg.wordline_group != 16:
        raise ValueError("the kernel's ADC groups are 16 rows "
                         f"(wordline_group={cfg.wordline_group})")
    w_e, ldk, ldn = w_q.stride()
    if not (ldk == 1 and (ldn >= K or N == 1)) and ldn != 1:
        raise ValueError(f"w_q strides {w_q.stride()}: one of the last two "
                         "must be 1")
    x_q = x_q.contiguous()
    vec_x = int(K % 16 == 0 and x_q.data_ptr() % 16 == 0)
    vec_w = int(ldk == 1 and (ldn % 16 == 0 or N == 1)
                and (E == 1 or w_e % 16 == 0) and w_q.data_ptr() % 16 == 0)
    quantized = cfg.adc_mode == "quantized"
    table, consts = None, (0.0,) * 4
    if quantized:
        if cfg.adc_bits > 8:
            raise ValueError(f"the kernel's ADC takes at most 8 bits ({cfg.adc_bits})")
        consts = adc_table(cfg)[1]
        table = _device_table(cfg, dev)
    splits, k_split = split_k(M, N, K, _sm_count(dev.index or 0), E)
    out = torch.empty((E, M, N), dtype=torch.float32, device=dev)
    part = counters = None
    if splits > 1:
        part = torch.empty((E, splits, M, N), dtype=torch.int32, device=dev)
        counters = _tile_counters(dev)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    err = _lib().pim_matmul_launch(
        x_q.data_ptr(), w_q.data_ptr(), out.data_ptr(), ptr(part),
        ptr(counters), ptr(table), 0 if table is None else table.shape[0],
        E, M, N, K, K, ldk, ldn, M * K, w_e, vec_x, vec_w, splits, k_split,
        int(quantized), quant.adc_step(cfg), *consts,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "pim_matmul launch")
    _build.LAUNCHES["pim_matmul_experts" if stacked else "pim_matmul"] += 1
    return out if stacked else out[0]
