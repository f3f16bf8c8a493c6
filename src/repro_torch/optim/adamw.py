"""AdamW with global-norm clipping and a warmup + cosine schedule over
parameter trees.

Counterpart of the JAX package's `optim/adamw.py`, op for op: the moments
are float32, the step a 0-d int32 tensor, the schedule and the bias
corrections float32 tensors computed from it, and the global norm sums the
leaves in the reference's flatten order (dict keys sorted, tuples in
order).  `update` is functional: it returns new trees and leaves its
inputs as they are.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch

from repro_torch.checkpoint.checkpoint import flatten, unflatten
from repro_torch.configs.base import TrainConfig


def init(params) -> Dict[str, Any]:
    leaves = flatten(params)

    def zeros():
        return unflatten(params, [torch.zeros_like(p, dtype=torch.float32)
                                  for p in leaves])

    return {"m": zeros(), "v": zeros(),
            "step": torch.zeros((), dtype=torch.int32,
                                device=leaves[0].device)}


def lr_schedule(step: torch.Tensor, cfg: TrainConfig) -> torch.Tensor:
    step = step.float()
    warm = torch.clamp_max(step / max(cfg.warmup_steps, 1), 1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.learning_rate * warm * (0.1 + 0.9 * cos)


def _global_norm(grads) -> torch.Tensor:
    """sqrt of the sum of every leaf's float32 sum of squares, the leaves
    added in order."""
    total = 0
    for g in flatten(grads):
        total = total + torch.sum(torch.square(g.float()))
    return torch.sqrt(total)


def _clip_scale(gn: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp_max(max_norm / torch.clamp_min(gn, 1e-9), 1.0)


def clip_by_global_norm(grads, max_norm: float):
    gn = _global_norm(grads)
    scale = _clip_scale(gn, max_norm)
    return unflatten(grads, [g * scale.to(g.dtype) for g in flatten(grads)]), gn


def update(grads, state, params, cfg: TrainConfig):
    """Returns (new_params, new_state, metrics).  Leaf by leaf, so that
    only one leaf's temporaries are live beside the trees."""
    gn = _global_norm(grads)
    scale = _clip_scale(gn, cfg.grad_clip)
    step = state["step"] + 1
    lr = lr_schedule(step, cfg)
    b1, b2 = cfg.beta1, cfg.beta2
    bc1 = 1 - b1 ** step.float()
    bc2 = 1 - b2 ** step.float()
    new_p, new_m, new_v = [], [], []
    for g, m, v, p in zip(flatten(grads), flatten(state["m"]),
                          flatten(state["v"]), flatten(params)):
        g = g.float() * scale
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        delta = (m / bc1) / (torch.sqrt(v / bc2) + 1e-8) \
            + cfg.weight_decay * p.float()
        new_p.append((p - lr * delta.to(p.dtype)).to(p.dtype))
        new_m.append(m)
        new_v.append(v)
    return (unflatten(params, new_p),
            {"m": unflatten(params, new_m), "v": unflatten(params, new_v),
             "step": step},
            {"lr": lr, "grad_norm": gn})
