"""mistral-large-123b [dense] — hf:mistralai/Mistral-Large-Instruct-2407 (unverified)."""
import dataclasses
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mistral-large-123b", family="dense",
    num_layers=88, d_model=12288, num_heads=96, num_kv_heads=8,
    head_dim=128, d_ff=28672, vocab_size=32768,
    activation="swiglu", norm="rmsnorm", rope_theta=1_000_000.0,
    max_seq_len=32768, block_pattern=("attn",),
)

SMOKE = dataclasses.replace(
    CONFIG, num_layers=4, d_model=128, num_heads=4, num_kv_heads=2,
    head_dim=32, d_ff=256, vocab_size=256, max_seq_len=128,
)
