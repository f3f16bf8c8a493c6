"""dbrx-132b [moe] — 16 experts top-4, fine-grained
(hf:databricks/dbrx-base; unverified)."""
import dataclasses
from repro_torch.configs.base import MoEConfig, ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b", family="moe",
    num_layers=40, d_model=6144, num_heads=48, num_kv_heads=8,
    head_dim=128, d_ff=10752, vocab_size=100352,
    activation="swiglu", norm="rmsnorm",
    max_seq_len=32768, block_pattern=("moe",),
    moe=MoEConfig(num_experts=16, num_shared=0, top_k=4),
)

SMOKE = dataclasses.replace(
    CONFIG, num_layers=3, d_model=64, num_heads=4, num_kv_heads=2,
    head_dim=16, d_ff=96, vocab_size=256, max_seq_len=128,
    moe=MoEConfig(num_experts=4, num_shared=0, top_k=2),
)
