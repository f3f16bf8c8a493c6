"""Public model bundle: `build_model(cfg, device)`, the parameter bridge
from the JAX package's trees and the training loss (`cross_entropy`,
`chunked_ce_from_hidden`).

Counterpart of the JAX package's `models/model_zoo.py`.  Training takes the
fp master tree (`init(deploy=False)`, `from_jax_params(deploy=False)`),
which `deploy_tree` turns into the serving form.  The
port's serving parameters are deployed once at load: every PIM linear's
weight is quantized to int8 with per-channel scales in the compute dtype,
which is what the reference's QAT layer computes from `w.astype(compute
dtype)` on every call, and the embedding tables are held in the compute
dtype, which is the only form the reference reads them in.  A MoE layer's
expert stacks (`experts` / `shared`: `w_in`, `w_gate`, `w_out`, (E, D, F)
arrays in the reference's tree) are deployed the same way, each expert
with its own int8 codes and per-output-channel scales: bit for bit what
the reference's vmapped QAT linear computes on every call (its own
`deploy_tree` leaves them in floating point).  An RG-LRU block's raw
float32 leaves (conv taps and bias, the (w, w) gate matrices, lambda) are
kept as they are: the reference reads them in float32, and so are an
mLSTM block's gate matrices and biases and an sLSTM block's input
matrices, recurrent blocks and biases (only their PIM linears, six in an
mLSTM block and the MLP's two in an sLSTM block, are deployed).
"""
from __future__ import annotations

import functools
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
    init: Callable[..., Any]            # (generator=None, seed=0, deploy=True) -> params
    init_cache: Callable[..., Any]      # (batch, max_len[, ragged, page_size, num_pages])
    forward_serve: Callable[..., Any]   # (params, batch, cache, offset[, seq_lens, pages, decode_rows, logit_positions, verify_len])
    forward_train: Callable[..., Any]   # (params, batch) -> (logits, aux)
    loss: Callable[..., Any]            # (params, batch) -> (loss, metrics)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean negative log-likelihood of `labels` under `logits`, in float32,
    over the positions `mask` keeps."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = logz - gold
    if mask is None:
        mask = torch.ones_like(nll)
    mask = mask.float()
    return torch.sum(nll * mask) / torch.clamp_min(torch.sum(mask), 1.0)


_CE_CHUNK = 512


def chunked_ce_from_hidden(hidden: torch.Tensor, head_table: torch.Tensor,
                           labels: torch.Tensor) -> torch.Tensor:
    """Sequence-chunked cross-entropy: positions 0..S-2 of `hidden` (B, S,
    D) predict labels 1..S-1.  Where those T = S - 1 positions are a
    multiple of _CE_CHUNK above it, each chunk computes its own (B, 512, V)
    logits tile against the (V, D) head table (cast per chunk, as the
    reference's scan body casts it) and the chunks' NLL sums add in order;
    otherwise one product and `cross_entropy`."""
    B, S, D = hidden.shape
    h = hidden[:, :-1]
    y = labels[:, 1:].long()
    T = h.shape[1]
    cq = _CE_CHUNK
    if T <= cq or T % cq:
        return cross_entropy(h @ head_table.to(h.dtype).t(), y)
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for lo in range(0, T, cq):
        lf = (h[:, lo:lo + cq] @ head_table.to(h.dtype).t()).float()
        logz = torch.logsumexp(lf, dim=-1)
        gold = torch.gather(lf, -1, y[:, lo:lo + cq, None])[..., 0]
        total = total + torch.sum(logz - gold)
    return total / (B * T)


def _is_linear(node) -> bool:
    return isinstance(node, dict) and (
        ("w" in node and set(node) <= {"w", "b"})
        or ("w_q" in node and set(node) <= {"w_q", "w_scale", "b"}))


_EXPERT_STACKS = ("experts", "shared")


def deploy_linear(node, cfg: ModelConfig):
    """One fp linear {"w"[, "b"]} -> its serving form (int8 codes in the
    (K, N) view, per-channel scales); deployed linears and the fp linears
    of a config without PIM linears are kept as they are."""
    if "w_q" in node or not cfg.pim_linears:
        return node
    out = pim.deploy_params(node, cfg.pim, dtype=getattr(torch, cfg.compute_dtype))
    out["w_q"] = pim.kn_view(out["w_q"])
    return out


def deploy_tree(params, cfg: ModelConfig):
    """fp parameters -> serving parameters (see the module docstring).
    Already deployed linears ({"w_q", "w_scale"}) are kept as they are."""
    dtype = getattr(torch, cfg.compute_dtype)

    def visit(node, key=None):
        if _is_linear(node):
            return deploy_linear(node, cfg)
        if key in _EXPERT_STACKS:
            # the reference's bare expert arrays become linears
            return {k: visit(v if _is_linear(v) else {"w": v})
                    for k, v in node.items()}
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


def from_jax_params(tree, cfg: ModelConfig, device=None, deploy: bool = True):
    """The JAX package's parameter tree (its leaves as numpy arrays, e.g.
    from `jax.device_get`) -> the port's serving parameters on `device`.
    QAT trees are deployed here, once; deployed trees are taken as they
    are.  With `deploy=False` the tree's leaves are taken as they are (an
    fp master tree for training).  The stacked "blocks" layer axis is
    kept."""
    T.check_supported(cfg)
    device = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, (tuple, list)):
            return tuple(conv(v) for v in node)
        return _to_torch(node, device)

    return deploy_tree(conv(tree), cfg) if deploy else conv(tree)


def _drawn_experts(generator, cfg: ModelConfig, device, lead, d_in, d_out,
                   scale):
    """A stack of experts for `init`, drawn one expert at a time, each
    deployed at once into the stack's int8 store, so no fp copy of a whole
    stack is held (one layer of deepseek-moe-16b's routed w_in is 0.74 GB
    in float32, the whole fp tree about 66 GB); the other linears are
    drawn whole in fp and deployed by `deploy_tree`."""
    dtype = getattr(torch, cfg.compute_dtype)
    w_q = torch.empty(lead + (d_out, d_in), dtype=torch.int8,
                      device=device).transpose(-1, -2)
    w_scale = torch.empty(lead + (1, d_out), dtype=dtype, device=device)
    for i in np.ndindex(*lead):
        w = torch.randn((d_in, d_out), generator=generator,
                        device=device) * scale
        w_q[i], w_scale[i] = pim.quantize_weights(w.to(dtype), cfg.pim)
    return {"w_q": w_q, "w_scale": w_scale}


def _drawn_fp_experts(generator, device, lead, d_in, d_out, scale):
    """A stack of experts for `init(deploy=False)`: `_drawn_experts`'s
    draws, one expert at a time, kept in float32 as the reference's bare
    (..., E, d_in, d_out) array, so that `deploy_tree` of it equals
    `init()`'s store bit for bit."""
    w = torch.empty(lead + (d_in, d_out), device=device)
    for i in np.ndindex(*lead):
        w[i] = torch.randn((d_in, d_out), generator=generator,
                           device=device) * scale
    return w


def _whole_fp_experts(generator, device, lead, d_in, d_out, scale):
    """Without PIM linears `init()` draws a stack whole, as any linear:
    the same draw, as a bare array."""
    return torch.randn(lead + (d_in, d_out), generator=generator,
                       device=device) * scale


def build_model(cfg: ModelConfig, device=None) -> Model:
    """Model bundle on `device` (default: the GPU; raises without one)."""
    T.check_supported(cfg)
    device = resolve_device(device)

    def init(generator: Optional[torch.Generator] = None, seed: int = 0,
             deploy: bool = True):
        """Random parameters from `generator` (else a generator on the
        model's device seeded with `seed`): the serving tree, or with
        `deploy=False` the fp master tree of the same draws, a MoE arch's
        expert stacks as the reference's bare arrays."""
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(seed)
        if not deploy:
            experts = None
            if cfg.moe.num_experts:
                if cfg.pim_linears:
                    experts = functools.partial(_drawn_fp_experts, generator,
                                                device)
                else:
                    experts = functools.partial(_whole_fp_experts, generator,
                                                device)
            return T.init_params(generator, cfg, device, experts)
        experts = None
        if cfg.pim_linears:
            experts = functools.partial(_drawn_experts, generator, cfg, device)
        # each linear (a stack of them) is deployed as soon as it is drawn,
        # so no fp copy of the whole tree is held (gemma-7b's is 34 GB)
        return deploy_tree(T.init_params(
            generator, cfg, device, experts,
            deploy=functools.partial(deploy_linear, cfg=cfg)), cfg)

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

    def forward_train(params, batch):
        return T.forward_train(params, batch, cfg)

    def loss(params, batch):
        hidden, aux = T.forward_hidden(params, batch, cfg)
        head = params["embed"] if cfg.tie_embeddings else params["unembed"]
        ce = chunked_ce_from_hidden(hidden, head["table"], batch["tokens"])
        total = ce + aux
        return total, {"loss": total, "ce": ce, "aux": aux}

    return Model(cfg, device, init, init_cache, forward_serve, forward_train,
                 loss)
