"""Mixture-of-Experts FFN (DeepSeekMoE / DBRX style: shared + routed top-k)
on the serve path.

Counterpart of the JAX package's `models/moe.py` without expert
parallelism (`ep_axis=None`).  Routing is local capacity routing with token
dropping: every row of the step (padding included) picks its top-k experts,
each expert takes at most C = max(ceil(T * k * cf / E), 1) picks in the
order of a stable sort of the flat expert ids, and the rest are dropped.
The kept rows form an (E, C, D) dispatch buffer that the stacked expert
FFNs run through kernel 3's expert launch (`layers.mlp_apply` over the
stacks: `core/pim.py` takes (E, D, F) weights), each expert a
weight-stationary PIM engine with its own per-channel scales.

The result equals the reference's eager run bit for bit in bfloat16:
  * the router is a float32 product, softmax, top-k and the normalisation
    gate / max(sum, 1e-9) (TF32 must be off on the card);
  * a token's picks are combined as the reference's scatter-add adds
    them, in ascending expert id, one rounding per add in the compute
    dtype, here as a gather and a fixed sequence of adds: no float
    atomics, whose order would make a bfloat16 token's bits depend on
    thread timing;
  * a dropped pick adds `value x 0`, as the reference's gather of the
    clamped slot times its masked gate does.
No step reads a value back to the host: C is a shape the host knows.  The
load-balance aux loss is a training term (`with_aux=True`, the training
forward); serving drops it, as the reference's serve block does.

Training carries gradients through the same ops: to the router through
the top-k gates, their normalisation and the aux term's mean
probabilities; to the tokens through the dispatch gather and the combine
gather and adds (a dropped pick is `value x 0`, a zero gradient); to the
expert stacks through the STE linear over each expert (`core/pim.py`).
The fp tree's expert stacks are the reference's bare (..., E, D, F)
arrays; `models/model_zoo.deploy_tree` makes them linears.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import mlp_apply

# global tokens per dispatch (bounds the (E, C, D) buffer); the reference's
_MOE_TOKEN_CHUNK = 131_072


def moe_ffn_init(normal, cfg: ModelConfig, lead: Tuple[int, ...], linear):
    """Parameters of one MoE FFN (or a stack of them, `lead` the layer
    axis) in the reference's tree: the float32 router and the stacked
    expert linears, each a `linear(lead + (n,), d_in, d_out, scale)`
    node."""
    m = cfg.moe
    d, f = cfg.d_model, cfg.d_ff
    glu = cfg.activation in ("swiglu", "geglu")

    def stack(n):
        def lin(d_in, d_out):
            return linear(lead + (n,), d_in, d_out, 1.0 / math.sqrt(d_in))

        p = {"w_in": lin(d, f), "w_out": lin(f, d)}
        if glu:
            p["w_gate"] = lin(d, f)
        return p

    p = {"router": normal(lead + (d, m.num_experts), 0.02),
         "experts": stack(m.num_experts)}
    if m.num_shared:
        p["shared"] = stack(m.num_shared)
    return p


def capacity(T: int, cfg: ModelConfig) -> int:
    """Slots per expert for a step of T rows."""
    m = cfg.moe
    return max(int(math.ceil(T * m.top_k * m.capacity_factor / m.num_experts)), 1)


def _route(params, xf: torch.Tensor, cfg: ModelConfig):
    """(probs, gate, idx): the float32 router probabilities (T, E) and
    `route`'s picks."""
    logits = xf.float() @ params["router"]
    probs = torch.softmax(logits, dim=-1)
    gate, idx = torch.topk(probs, cfg.moe.top_k, dim=-1)
    # summed left to right, as XLA sums the k gates on the CPU (torch's
    # sum of 6 floats rounds otherwise)
    total = gate[:, :1]
    for i in range(1, gate.shape[1]):
        total = total + gate[:, i:i + 1]
    return probs, gate / torch.clamp(total, min=1e-9), idx


def route(params, xf: torch.Tensor, cfg: ModelConfig):
    """(gate, idx): each row's top-k experts, (T, k) int64 in descending
    probability, and their float32 gates normalised over the k."""
    return _route(params, xf, cfg)[1:]


def load_balance_aux(probs: torch.Tensor, idx: torch.Tensor,
                     cfg: ModelConfig) -> torch.Tensor:
    """The Switch load-balance term in float32: E * sum_e f_e * P_e *
    router_aux_weight, f_e the share of rows' picks that chose expert e
    (its pick count over T, as the mean of the one-hot sums is) and P_e
    its mean probability."""
    E = cfg.moe.num_experts
    picks = idx[:, :, None] == torch.arange(E, device=idx.device)
    f_e = picks.sum(dim=(0, 1)).float() / idx.shape[0]
    return E * torch.sum(f_e * probs.mean(dim=0)) * cfg.moe.router_aux_weight


def dispatch(xf: torch.Tensor, idx: torch.Tensor, C: int, E: int):
    """(xe, slot, keep): the (E, C, D) dispatch buffer, and each pick's
    slot e * C + rank and whether it was kept (rank < C), (T, k).  A pick's
    rank is its place among expert e's picks in the stable order of the
    flat ids; expert e's slot c holds the token of its c-th pick, and
    slots past its count are zero rows."""
    T, k = idx.shape
    ids = idx.reshape(-1)
    order = torch.argsort(ids, stable=True)
    sorted_ids = ids[order]
    experts = torch.arange(E, device=xf.device)
    starts = torch.searchsorted(sorted_ids, experts)
    counts = torch.searchsorted(sorted_ids, experts, right=True) - starts
    # inverse of the sort: the sorted position of each flat pick
    pos = torch.empty_like(order)
    pos[order] = torch.arange(T * k, device=xf.device)
    rank = (pos - starts[ids]).view(T, k)
    keep = rank < C
    slot = idx * C + rank
    c = torch.arange(C, device=xf.device)
    src = torch.clamp(starts[:, None] + c, max=T * k - 1)
    tok = order[src] // k                                   # (E, C)
    xe = torch.where((c < counts[:, None])[..., None], xf[tok],
                     torch.zeros((), dtype=xf.dtype, device=xf.device))
    return xe, slot, keep


def combine(ye: torch.Tensor, gate: torch.Tensor, idx: torch.Tensor,
            slot: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """(T, D): each token's expert outputs times their masked gates (cast
    to the compute dtype), summed in ascending expert id from zero, one
    rounding per add, as the reference's scatter-add adds them."""
    E, C, D = ye.shape
    T, k = idx.shape
    ye_flat = ye.reshape(E * C, D)
    w = torch.where(keep, gate, torch.zeros((), device=gate.device)).to(ye.dtype)
    contrib = ye_flat[torch.clamp(slot, max=E * C - 1)] * w[..., None]
    by_expert = torch.argsort(idx, dim=-1)
    contrib = torch.gather(contrib, 1, by_expert[..., None].expand(T, k, D))
    y = torch.zeros((T, D), dtype=ye.dtype, device=ye.device)
    for i in range(k):
        y = y + contrib[:, i]
    return y


def _stack(params):
    """An expert stack as linears: the fp tree's bare (E, D, F) arrays
    become {"w"}; deployed stacks are linears already."""
    return {k: v if isinstance(v, dict) else {"w": v}
            for k, v in params.items()}


def moe_ffn_local(params, xf: torch.Tensor, cfg: ModelConfig,
                  with_aux: bool = False):
    """Route T local tokens, (T, D) -> (T, D); with `with_aux` (y, aux),
    aux the float32 load-balance term."""
    m = cfg.moe
    T = xf.shape[0]
    probs, gate, idx = _route(params, xf, cfg)
    xe, slot, keep = dispatch(xf, idx, capacity(T, cfg), m.num_experts)
    # (E, C, D) through the expert stacks: per-token scales over each row
    # of each expert, per-channel scales per expert
    y = combine(mlp_apply(_stack(params["experts"]), xe, cfg), gate, idx,
                slot, keep)
    if m.num_shared:
        shared = mlp_apply(_stack(params["shared"]),
                           xf.expand((m.num_shared,) + xf.shape), cfg)
        y = y + shared.sum(0)
    if not with_aux:
        return y
    return y, load_balance_aux(probs, idx, cfg)


def moe_ffn_apply(params, x: torch.Tensor, cfg: ModelConfig,
                  with_aux: bool = False):
    """(B, S, D) -> (B, S, D), or with `with_aux` (y, aux).  A step of more
    than _MOE_TOKEN_CHUNK rows is routed in chunks along the sequence axis
    (the smallest divisor nc of S with B * S / nc within the budget), as
    the reference's scan does, which averages the chunks' aux terms as
    acc + aux / nc in chunk order from a float32 zero."""
    B, S, D = x.shape
    T = B * S
    nc = 1
    if T > _MOE_TOKEN_CHUNK:
        for cand in range(2, S + 1):
            if S % cand == 0 and T // cand <= _MOE_TOKEN_CHUNK:
                nc = cand
                break
    if nc == 1:
        out = moe_ffn_local(params, x.reshape(T, D), cfg, with_aux)
        if not with_aux:
            return out.reshape(B, S, D)
        return out[0].reshape(B, S, D), out[1]
    xc = x.reshape(B, nc, S // nc, D)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    ys = []
    for i in range(nc):
        out = moe_ffn_local(params, xc[:, i].reshape(B * (S // nc), D), cfg,
                            with_aux)
        if with_aux:
            out, a = out
            aux = aux + a / nc
        ys.append(out.reshape(B, S // nc, D))
    y = torch.stack(ys, dim=1).reshape(B, S, D)
    return (y, aux) if with_aux else y
