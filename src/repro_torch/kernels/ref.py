"""Two-pass oracle of the fused PIM attention kernels.

Counterpart of the JAX package's `kernels/ref.py::pim_attention_ref`: the
same LUT arithmetic as the kernels, with the global row max in place of the
online running max (so the kernels agree with it to rounding, not bits).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import LUTSoftmaxConfig
from repro_torch.core.lut_softmax import build_exp_table

_NEG = -(1 << 24)


def pim_attention_ref(q_q, q_scale, k_q, k_scale, v_q, v_scale, q_offset,
                      kv_len, lut_cfg: LUTSoftmaxConfig = LUTSoftmaxConfig(),
                      causal: bool = True, window: int = 0) -> torch.Tensor:
    """q_q (BH, Sq, Dh) int8 with (BH, Sq) scales; K/V (BHkv, Sk, Dh) int8
    with (BHkv, Sk) scales; scalar `q_offset` and `kv_len`.  Returns
    (BH, Sq, Dh) float32."""
    BH, Sq, Dh = q_q.shape
    BHkv, Sk, _ = k_q.shape
    qpk = BH // BHkv
    k_q = torch.repeat_interleave(k_q, qpk, dim=0)
    v_q = torch.repeat_interleave(v_q, qpk, dim=0)
    k_scale = torch.repeat_interleave(k_scale, qpk, dim=0)
    v_scale = torch.repeat_interleave(v_scale, qpk, dim=0)

    s_int = torch.einsum("bqd,bkd->bqk", q_q.double(), k_q.double()).float()
    sm = 1.0 / (Dh ** 0.5)
    s_real = s_int * q_scale.float()[:, :, None] * k_scale[:, None, :] * sm
    qmax = float((1 << (lut_cfg.input_bits - 1)) - 1)
    codes = torch.clamp(torch.round(s_real / lut_cfg.score_scale),
                        -qmax - 1.0, qmax)

    dev = q_q.device
    q_pos = q_offset + torch.arange(Sq, device=dev)[:, None]
    k_pos = torch.arange(Sk, device=dev)[None, :]
    mask = k_pos < kv_len
    if causal:
        mask = mask & (k_pos <= q_pos)
    if window:
        mask = mask & (k_pos > q_pos - window)
    codes = torch.where(mask[None], codes, float(_NEG))

    table, _ = build_exp_table(lut_cfg, dev)
    m = codes.amax(dim=-1, keepdim=True)
    d = torch.clamp(m - codes, 0, 255).long()
    e = torch.where(mask[None], table[d].float(), 0.0)
    denom = torch.clamp_min(e.sum(dim=-1, keepdim=True), 1.0)
    v_deq = v_q.float() * v_scale[..., None]
    return torch.einsum("bqk,bkd->bqd", e / denom, v_deq)
