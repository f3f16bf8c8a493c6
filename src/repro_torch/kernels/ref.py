"""Oracles of the kernels.

Counterpart of the JAX package's `kernels/ref.py`.  The matmul and softmax
oracles are the reference's behavioral arithmetic, float32 sums included
(the kernels are bit-true to it wherever those sums are exact).  The
attention oracle has the same LUT arithmetic as the fused kernels, with the
global row max in place of the online running max (so the kernels agree
with it to rounding, not bits).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import LUTSoftmaxConfig, PIMConfig
from repro_torch.core import quant
from repro_torch.core.lut_softmax import build_exp_table, lut_softmax_codes

_NEG = -(1 << 24)


def pim_matmul_int_ref(x_q: torch.Tensor, w_q: torch.Tensor,
                       cfg: PIMConfig) -> torch.Tensor:
    """(M, K) int8 x (K, N) int8 -> (M, N) f32 on the accumulation grid:
    each 16-row group's ADC output, code * step, summed in float32."""
    if cfg.adc_mode == "ideal":
        return (x_q.double() @ w_q.double()).float()
    g = cfg.wordline_group
    pad = (-x_q.shape[1]) % g
    f = torch.nn.functional
    xg = f.pad(x_q, (0, pad)).double()
    wg = f.pad(w_q.t(), (0, pad)).t().double()
    xg = xg.reshape(xg.shape[0], -1, g)
    wg = wg.reshape(-1, g, wg.shape[1])
    psum = torch.einsum("mgk,gkn->mgn", xg, wg)
    return quant.adc_transfer(psum, cfg.adc_bits,
                              quant.adc_full_range(cfg)).sum(dim=1)


def lut_softmax_ref(scores_q: torch.Tensor, mask: torch.Tensor,
                    cfg: LUTSoftmaxConfig) -> torch.Tensor:
    """(R, S) score codes -> (R, S) Q0.16 probability codes."""
    return lut_softmax_codes(scores_q, cfg, mask=mask)


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
