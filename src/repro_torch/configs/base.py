"""Configuration dataclasses, copied from the JAX package's `configs/base.py`.

The port keeps its own copy so that it imports nothing of the JAX package.
Only the parts the serving path reads are kept: the PIM macro model, the LUT
softmax and the model architecture.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class PIMConfig:
    """Behavioral model of the paper's APIM macro (AttentionLego §3.2)."""

    macro_rows: int = 128          # word-lines per macro
    macro_cols: int = 128          # bit-lines per macro
    weight_bits: int = 8           # in-array weight precision
    input_bits: int = 8            # DAC / input port precision
    adc_bits: int = 6              # ADC precision
    wordline_group: int = 16       # rows active per analog step
    # "ideal" -> exact integer accumulation; "quantized" -> every 16-row
    # partial sum passes through the saturating `adc_bits` ADC
    adc_mode: str = "ideal"
    # ADC full-scale as a fraction of the per-group theoretical max |psum|
    adc_range_frac: float = 0.125
    per_channel: bool = True       # per-output-channel weight scales


@dataclasses.dataclass(frozen=True)
class LUTSoftmaxConfig:
    """Look-up-table softmax: 8-bit fixed-point in, 16-bit out (§3.4)."""

    input_bits: int = 8            # score precision entering the LUT
    table_bits: int = 16           # exp table entry width
    table_frac_bits: int = 15      # Q1.15 for exp(x) in (0, 2)
    out_frac_bits: int = 16        # probability fixed point Q0.16
    # "paper": indexed by the raw score byte; "shifted": row max subtracted
    # in the integer domain first (the mode the models use)
    mode: str = "shifted"
    score_scale: float = 1.0 / 16.0  # score byte b represents b * score_scale

    @property
    def table_size(self) -> int:
        return 1 << self.input_bits


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 0
    num_shared: int = 0
    top_k: int = 2
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"
    num_layers: int = 4
    d_model: int = 256
    num_heads: int = 4
    num_kv_heads: int = 4
    head_dim: int = 0              # 0 -> d_model // num_heads
    d_ff: int = 1024
    vocab_size: int = 1024
    activation: str = "swiglu"
    norm: str = "rmsnorm"
    qkv_bias: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 10_000.0
    pos: str = "rope"
    max_seq_len: int = 8192
    attn_kind: str = "full"
    window: int = 0
    causal: bool = True
    block_pattern: Tuple[str, ...] = ("attn",)
    is_encoder_decoder: bool = False
    num_encoder_layers: int = 0
    encoder_seq_len: int = 0
    num_image_patches: int = 0
    lru_width: int = 0
    conv1d_width: int = 4
    num_dense_layers: int = 0
    moe: MoEConfig = MoEConfig()
    attn_impl: str = "behavioral"  # behavioral|kernel (serve-path attention)
    decode_kernel: bool = True     # Sq == 1 steps go to the split-K kernel
    decode_block_k: int = 256      # KV partition size of the split-K grid
    kv_bits: int = 8               # 8 = int8 KV, 4 = packed dynamic-map codes
    remat: str = "block"
    pim: PIMConfig = PIMConfig()
    lut: LUTSoftmaxConfig = LUTSoftmaxConfig()
    pim_linears: bool = True
    pim_attention: bool = True
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.num_heads

    def param_count(self) -> int:
        """Analytic parameter count of an attention or MoE stack (embedding,
        blocks, head): a MoE layer counts every routed and shared expert and
        the router, a dense prefix layer its MLP."""
        d, h = self.d_model, self.resolved_head_dim
        attn = d * h * self.num_heads + 2 * d * h * self.num_kv_heads \
            + h * self.num_heads * d
        mult = 3 if self.activation in ("swiglu", "geglu") else 2
        ffn_dense = mult * d * self.d_ff
        ffn, dense = ffn_dense, self.num_layers
        if self.moe.num_experts:
            ffn = (self.moe.num_experts + self.moe.num_shared) * ffn_dense \
                + d * self.moe.num_experts
            dense = self.num_dense_layers
        total = (dense * (attn + ffn_dense + 2 * d)
                 + (self.num_layers - dense) * (attn + ffn + 2 * d)
                 + self.vocab_size * d)
        if not self.tie_embeddings:
            total += self.vocab_size * d
        return total


def _pattern_kinds(cfg: ModelConfig) -> Tuple[str, ...]:
    """Expand block_pattern to num_layers entries."""
    pat = cfg.block_pattern
    reps = -(-cfg.num_layers // len(pat))
    return (pat * reps)[: cfg.num_layers]
