"""The training step: gradients through the model's loss, microbatched
accumulation and the AdamW update, on one device.

Counterpart of the JAX package's `runtime/train_lib.py` without a mesh:
its jitted step becomes an eager function with the same arithmetic.  A
mesh, and int8 gradient compression (whose only caller is the mesh path),
are ROADMAP.md §1 item 9.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch

from repro_torch.checkpoint.checkpoint import flatten, unflatten
from repro_torch.configs.base import TrainConfig
from repro_torch.models.model_zoo import Model
from repro_torch.optim import adamw


def _split_microbatches(batch: Dict[str, torch.Tensor], m: int) -> list:
    """(B, ...) leaves -> m batches of B / m rows each, in order."""
    for k, a in batch.items():
        assert a.shape[0] % m == 0, (k, a.shape[0], m)
    return [{k: a.reshape(m, a.shape[0] // m, *a.shape[1:])[i]
             for k, a in batch.items()} for i in range(m)]


def grad_fn(model: Model) -> Callable:
    """fn(params, batch) -> (grads, loss, metrics): the gradient of
    `model.loss` at every leaf of `params` (zeros at a leaf the loss does
    not read, as the reference's), the loss and its metrics, detached."""
    def fn(params, batch):
        leaves = [p.detach().requires_grad_(True) for p in flatten(params)]
        loss, metrics = model.loss(unflatten(params, leaves), batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        return (unflatten(params, grads), loss.detach(),
                {k: v.detach() for k, v in metrics.items()})
    return fn


def _no_mesh(mesh, tcfg: TrainConfig) -> None:
    if mesh is not None:
        raise NotImplementedError("training over a mesh is ROADMAP.md §1 "
                                  "item 9")
    if tcfg.grad_compression != "none":
        raise NotImplementedError(
            f"grad_compression={tcfg.grad_compression!r} (the mesh path's "
            "int8 all-reduce) is ROADMAP.md §1 item 9")


def make_train_step(model: Model, tcfg: TrainConfig, mesh=None) -> Callable:
    """step(params, opt_state, batch) -> (params, opt_state, metrics).
    Returns new trees (the reference's jitted step donates its inputs;
    this one leaves them as they are)."""
    _no_mesh(mesh, tcfg)
    gfn = grad_fn(model)
    m = tcfg.microbatches

    def accumulate(params, batch):
        if m == 1:
            grads, _, metrics = gfn(params, batch)
            return grads, metrics
        acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for p in flatten(params)]
        loss_acc = torch.zeros((), dtype=torch.float32,
                               device=acc[0].device)
        for mb in _split_microbatches(batch, m):
            grads, loss, _ = gfn(params, mb)
            acc = [a + g.float() / m for a, g in zip(acc, flatten(grads))]
            loss_acc = loss_acc + loss / m
        return unflatten(params, acc), {"loss": loss_acc}

    def step(params, opt_state, batch):
        grads, metrics = accumulate(params, batch)
        params, opt_state2, om = adamw.update(
            grads, {k: opt_state[k] for k in ("m", "v", "step")}, params,
            tcfg)
        return params, dict(opt_state, **opt_state2), dict(metrics, **om)

    return step


def init_opt_state(params, tcfg: TrainConfig):
    _no_mesh(None, tcfg)
    return adamw.init(params)
