"""Public model bundle: `build_model(cfg, device)` and the parameter bridge
from the JAX package's trees.

Counterpart of the JAX package's `models/model_zoo.py` for serving.  The
port's serving parameters are deployed once at load: every PIM linear's
weight is quantized to int8 with per-channel scales in the compute dtype,
which is what the reference's QAT layer computes from `w.astype(compute
dtype)` on every call, and the embedding tables are held in the compute
dtype, which is the only form the reference reads them in.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import pim
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T


class Model(NamedTuple):
    cfg: ModelConfig
    device: torch.device
    init: Callable[..., Any]            # (generator=None, seed=0) -> params
    init_cache: Callable[..., Any]      # (batch, max_len[, ragged, page_size, num_pages])
    forward_serve: Callable[..., Any]   # (params, batch, cache, offset[, seq_lens, pages, decode_rows, logit_positions, verify_len])


def _is_linear(node) -> bool:
    return isinstance(node, dict) and (
        ("w" in node and set(node) <= {"w", "b"})
        or ("w_q" in node and set(node) <= {"w_q", "w_scale", "b"}))


def deploy_tree(params, cfg: ModelConfig):
    """fp parameters -> serving parameters (see the module docstring).
    Already deployed linears ({"w_q", "w_scale"}) are kept as they are."""
    dtype = getattr(torch, cfg.compute_dtype)

    def linear(node):
        if "w_q" in node or not cfg.pim_linears:
            return node
        out = pim.deploy_params(node, cfg.pim, dtype=dtype)
        # (K, N) views of an (N, K) store: the layout cuBLAS's int8 GEMM reads
        out["w_q"] = out["w_q"].transpose(-1, -2).contiguous().transpose(-1, -2)
        return out

    def visit(node, key=None):
        if _is_linear(node):
            return linear(node)
        if isinstance(node, dict):
            return {k: visit(v, k) for k, v in node.items()}
        if isinstance(node, (tuple, list)):
            return type(node)(visit(v) for v in node)
        if key == "table":
            return node.to(dtype)
        return node

    return visit(params)


def _to_torch(leaf, device) -> torch.Tensor:
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.uint16).astype(np.int16))
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


def from_jax_params(tree, cfg: ModelConfig, device=None):
    """The JAX package's parameter tree (its leaves as numpy arrays, e.g.
    from `jax.device_get`) -> the port's serving parameters on `device`.
    QAT trees are deployed here, once; deployed trees are taken as they
    are.  The stacked "blocks" layer axis is kept."""
    T.check_supported(cfg)
    device = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, (tuple, list)):
            return tuple(conv(v) for v in node)
        return _to_torch(node, device)

    return deploy_tree(conv(tree), cfg)


def build_model(cfg: ModelConfig, device=None) -> Model:
    """Model bundle on `device` (default: the GPU; raises without one)."""
    T.check_supported(cfg)
    device = resolve_device(device)

    def init(generator: Optional[torch.Generator] = None, seed: int = 0):
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(seed)
        return deploy_tree(T.init_params(generator, cfg, device), cfg)

    def init_cache(batch: int, max_len: int, ragged: bool = False,
                   page_size: int = 0, num_pages: int = 0):
        return T.init_cache(cfg, batch, max_len, device, ragged=ragged,
                            page_size=page_size, num_pages=num_pages)

    def forward_serve(params, batch, cache, offset, seq_lens=None,
                      pages=None, decode_rows=None, logit_positions=None,
                      verify_len: int = 1):
        return T.forward_serve(params, batch, cache, offset, cfg,
                               seq_lens=seq_lens, pages=pages,
                               decode_rows=decode_rows,
                               logit_positions=logit_positions,
                               verify_len=verify_len)

    return Model(cfg, device, init, init_cache, forward_serve)
