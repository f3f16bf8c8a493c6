"""internlm2-1.8b [dense] — GQA kv=8 (arXiv:2403.17297; hf)."""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internlm2-1.8b", family="dense",
    num_layers=24, d_model=2048, num_heads=16, num_kv_heads=8,
    head_dim=128, d_ff=8192, vocab_size=92544,
    activation="swiglu", norm="rmsnorm",
    max_seq_len=32768, block_pattern=("attn",),
)

SMOKE = dataclasses.replace(
    CONFIG, num_layers=4, d_model=128, num_heads=4, num_kv_heads=2,
    head_dim=32, d_ff=256, vocab_size=256, max_seq_len=128,
)
