"""qwen2-72b [dense] — GQA kv=8, QKV bias (arXiv:2407.10671; hf)."""
import dataclasses
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-72b", family="dense",
    num_layers=80, d_model=8192, num_heads=64, num_kv_heads=8,
    head_dim=128, d_ff=29568, vocab_size=152064,
    activation="swiglu", norm="rmsnorm", qkv_bias=True,
    max_seq_len=32768, block_pattern=("attn",),
)

SMOKE = dataclasses.replace(
    CONFIG, num_layers=4, d_model=128, num_heads=4, num_kv_heads=2,
    head_dim=32, d_ff=256, vocab_size=256, max_seq_len=128,
)
