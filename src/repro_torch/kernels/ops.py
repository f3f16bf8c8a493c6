"""Public wrappers over the attention kernels, in the model's layout.

Counterpart of the JAX package's `kernels/ops.py` for the attention path.
The kernels take head-major int8 operands; these wrappers quantize q, hand
the kernels views of the cache (the head-major dense planes, or the paged
pool as it is stored), and route each step: Sq == 1 (or
`force_decode_kernel`) to the split-K decode kernel, everything else to
the prefill kernel.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import LUTSoftmaxConfig, PIMConfig
from repro_torch.core import quant
from repro_torch.core.attention import KVCache, PagedKVCache
from repro_torch.kernels.pim_attention import pim_attention
from repro_torch.kernels.pim_decode import pim_decode


def _q_kernel_layout(q: torch.Tensor, input_bits: int):
    """(B, Sq, H, Dh) float q -> head-major int8 (B*H, Sq, Dh) + float32
    scales (computed in the dtype of q, as the reference does)."""
    B, Sq, H, Dh = q.shape
    q_scale = quant.symmetric_max_scale(q, input_bits, axis=-1)
    q_q = quant.quantize(q, q_scale, input_bits)
    q_q = q_q.permute(0, 2, 1, 3).reshape(B * H, Sq, Dh)
    qs = q_scale[..., 0].float().permute(0, 2, 1).reshape(B * H, Sq)
    return q_q, qs


def kernel_attention_layout(q: torch.Tensor, cache: KVCache,
                            input_bits: int = 8):
    """(B, Sq, H, Dh) q + KVCache -> (q_q, q_scale, k_q, k_scale, v_q,
    v_scale), q rows (B*H, Sq, ...) and KV rows (B*Hkv, Sk, ...), so that q
    row bh reads KV row bh // q_per_kv.  The KV operands are views of the
    head-major cache planes: no step copies the cache.  The KV last dim is
    the stored width (Dh / 2 at 4 bits), which is how the kernels learn the
    precision."""
    B, Hkv, Sk, Dhk = cache.k_q.shape
    q_q, qs = _q_kernel_layout(q, input_bits)
    return (q_q, qs, cache.k_q.view(B * Hkv, Sk, Dhk),
            cache.k_scale.view(B * Hkv, Sk), cache.v_q.view(B * Hkv, Sk, Dhk),
            cache.v_scale.view(B * Hkv, Sk))


def pim_flash_attention(q: torch.Tensor, cache: KVCache, q_offset,
                        pim_cfg: PIMConfig = PIMConfig(),
                        lut_cfg: LUTSoftmaxConfig = LUTSoftmaxConfig(),
                        causal: bool = True, window: int = 0,
                        out_dtype=torch.bfloat16, decode_kernel: bool = True,
                        decode_block_k: int = 256, q_len=None,
                        force_decode_kernel: bool = False) -> torch.Tensor:
    """Fused PIM attention over the int8 KV cache; (B, Sq, H, Dh) out.

    Sq == 1 steps go to the split-K decode kernel when `decode_kernel` is
    set; `force_decode_kernel` sends Sq > 1 verify rows there too, keeping
    each position bit-identical to the Sq == 1 step it replaces.  `q_len` is
    the optional (B,) count of valid query rows per sequence."""
    B, Sq, H, Dh = q.shape
    operands = kernel_attention_layout(q, cache, pim_cfg.input_bits)
    if decode_kernel and (Sq == 1 or force_decode_kernel):
        o = pim_decode(*operands, q_offset, cache.length, pim_cfg, lut_cfg,
                       causal=causal, window=window, block_k=decode_block_k,
                       q_len=q_len)
    else:
        o = pim_attention(*operands, q_offset, cache.length, pim_cfg, lut_cfg,
                          causal=causal, window=window, q_len=q_len)
    return o.reshape(B, H, Sq, Dh).permute(0, 2, 1, 3).to(out_dtype)


def pim_paged_flash_attention(q: torch.Tensor, pool: PagedKVCache,
                              page_table: torch.Tensor, kv_len: torch.Tensor,
                              q_offset: torch.Tensor,
                              pim_cfg: PIMConfig = PIMConfig(),
                              lut_cfg: LUTSoftmaxConfig = LUTSoftmaxConfig(),
                              causal: bool = True, out_dtype=torch.bfloat16,
                              decode_kernel: bool = True, q_len=None,
                              force_decode_kernel: bool = False
                              ) -> torch.Tensor:
    """Fused PIM attention over the paged pool, (B, Sq, H, Dh) out: both
    kernels walk each slot's row of the (B, n_tables) int32 `page_table`
    through the pool's own planes (no per-step transpose of the pool).
    Equal bit for bit to `pim_flash_attention` over a dense cache holding
    the same tokens at block_k == page_size.  Routing as there; paged
    layers have no sliding window."""
    B, Sq, H, Dh = q.shape
    q_q, qs = _q_kernel_layout(q, pim_cfg.input_bits)
    operands = (q_q, qs, pool.k_q, pool.k_scale, pool.v_q, pool.v_scale)
    if decode_kernel and (Sq == 1 or force_decode_kernel):
        o = pim_decode(*operands, q_offset, kv_len, pim_cfg, lut_cfg,
                       causal=causal, page_table=page_table, q_len=q_len)
    else:
        o = pim_attention(*operands, q_offset, kv_len, pim_cfg, lut_cfg,
                          causal=causal, page_table=page_table, q_len=q_len)
    return o.reshape(B, H, Sq, Dh).permute(0, 2, 1, 3).to(out_dtype)
