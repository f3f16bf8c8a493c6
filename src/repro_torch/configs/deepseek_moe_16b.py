"""deepseek-moe-16b [moe] — 2 shared + 64 routed top-6 fine-grained experts,
first layer dense (arXiv:2401.06066; hf)."""
import dataclasses
from repro_torch.configs.base import MoEConfig, ModelConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b", family="moe",
    num_layers=28, d_model=2048, num_heads=16, num_kv_heads=16,
    head_dim=128, d_ff=1408, vocab_size=102400,
    activation="swiglu", norm="rmsnorm",
    max_seq_len=32768, block_pattern=("moe",), num_dense_layers=1,
    moe=MoEConfig(num_experts=64, num_shared=2, top_k=6),
)

SMOKE = dataclasses.replace(
    CONFIG, num_layers=3, d_model=64, num_heads=2, num_kv_heads=2,
    head_dim=32, d_ff=96, vocab_size=256, max_seq_len=128,
    num_dense_layers=1, moe=MoEConfig(num_experts=4, num_shared=1, top_k=2),
)
