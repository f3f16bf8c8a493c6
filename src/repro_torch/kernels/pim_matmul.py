"""Macro-tiled PIM matmul: the CUDA kernel's wrapper and its plain PyTorch
version.

Counterpart of the JAX package's `kernels/pim_matmul.py`
(`pim_matmul_int_pallas`).  The kernel is `csrc/pim_matmul.cu`; its header
says what it computes, what bounds it on the card and how.

`pim_matmul_int` launches the kernel for CUDA tensors and runs
`pim_matmul_int_plain` for CPU tensors, never one in place of the other.
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
    "pim_matmul_launch": [_P] * 4 + [_I] * 3 + [_L] * 2 + [_I] * 6 + [_F] * 3
                         + [_P],
    "pim_matmul_block_m": [_I],
}
_BN, _BK = 64, 64          # output columns and K rows of a CTA tile
# float64 partial sums the plain version holds at once (512 MB)
_PLAIN_CHUNK = 1 << 26


def _check(x_q: torch.Tensor, w_q: torch.Tensor) -> None:
    if x_q.dim() != 2 or w_q.dim() != 2 or x_q.shape[1] != w_q.shape[0]:
        raise ValueError(f"pim_matmul takes (M, K) x (K, N), got "
                         f"{tuple(x_q.shape)} x {tuple(w_q.shape)}")
    if x_q.dtype != torch.int8 or w_q.dtype != torch.int8:
        raise ValueError("pim_matmul takes int8 operands")
    if x_q.device != w_q.device:
        raise ValueError(f"operands on {x_q.device} and {w_q.device}")


def pim_matmul_int(x_q: torch.Tensor, w_q: torch.Tensor,
                   cfg: PIMConfig = PIMConfig()) -> torch.Tensor:
    """(M, K) int8 x (K, N) int8 -> (M, N) float32 on the accumulation grid:
    exact int32 sums (ideal) or summed ADC codes times the step (quantized).
    `w_q` is read as stored, at its offset and strides (one of them 1)."""
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
    M, K = x_q.shape
    N = w_q.shape[1]
    if cfg.adc_mode == "ideal":
        return (x_q.double() @ w_q.double()).float()
    g = cfg.wordline_group
    pad = (-K) % g
    f = torch.nn.functional
    G = (K + pad) // g
    xg = f.pad(x_q, (0, pad)).view(M, G, g).transpose(0, 1).double()
    wg = f.pad(w_q.t(), (0, pad)).t().reshape(G, g, N).double()
    codes = torch.zeros((M, N), dtype=torch.int32, device=x_q.device)
    per = max(1, _PLAIN_CHUNK // max(1, M * N))
    for lo in range(0, G, per):
        # (groups, M, N) partial sums, one per word-line group
        psum = torch.bmm(xg[lo:lo + per], wg[lo:lo + per])
        code = quant.adc_code(psum, cfg.adc_bits, quant.adc_full_range(cfg))
        codes += code.to(torch.int32).sum(dim=0, dtype=torch.int32)
    step = torch.full((), quant.adc_step(cfg), device=x_q.device)
    return codes.float() * step


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def split_k(M: int, N: int, K: int, block_m: int, sms: int):
    """(splits, K rows per split): K is cut into 64-row-aligned ranges until
    the grid has about two CTAs per SM (decode's few rows leave few tiles)."""
    tiles = -(-N // _BN) * -(-M // block_m)
    want = max(1, min(-(-2 * sms // tiles), -(-K // _BK)))
    k_split = -(-(-(-K // want)) // _BK) * _BK
    return -(-K // k_split), k_split


def _lib():
    return _build.load("pim_matmul", _SIGNATURES)


def _launch(x_q: torch.Tensor, w_q: torch.Tensor, cfg: PIMConfig):
    M, K = x_q.shape
    N = w_q.shape[1]
    dev = x_q.device
    if cfg.wordline_group != 16:
        raise ValueError("the kernel's ADC groups are 16 rows "
                         f"(wordline_group={cfg.wordline_group})")
    ldk, ldn = w_q.stride()
    if ldk == 1 and (ldn >= K or N == 1):
        kmajor = 1
    elif ldn == 1:
        kmajor = 0
    else:
        raise ValueError(f"w_q strides {w_q.stride()}: one of them must be 1")
    x_q = x_q.contiguous()
    vec_x = int(K % 4 == 0 and x_q.data_ptr() % 4 == 0)
    vec_w = int((ldn if kmajor else ldk) % 4 == 0 and w_q.data_ptr() % 4 == 0)
    lib = _lib()
    splits, k_split = split_k(M, N, K, lib.pim_matmul_block_m(M),
                              _sm_count(dev.index or 0))
    out = torch.empty((M, N), dtype=torch.float32, device=dev)
    part = None if splits == 1 else torch.empty((splits, M, N),
                                                dtype=torch.int32, device=dev)
    half = 1 << (cfg.adc_bits - 1)
    err = lib.pim_matmul_launch(
        x_q.data_ptr(), w_q.data_ptr(), out.data_ptr(),
        None if part is None else part.data_ptr(), M, N, K, ldk, ldn, kmajor,
        vec_x, vec_w, splits, k_split, int(cfg.adc_mode == "quantized"),
        quant.adc_step(cfg), float(-half), float(half - 1),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "pim_matmul launch")
    _build.LAUNCHES["pim_matmul"] += 1
    return out
