"""gemma-7b [dense] — GeGLU, head_dim=256, GQA kv=16 (arXiv:2403.08295; hf)."""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma-7b", family="dense",
    num_layers=28, d_model=3072, num_heads=16, num_kv_heads=16,
    head_dim=256, d_ff=24576, vocab_size=256_000,
    activation="geglu", norm="rmsnorm", tie_embeddings=True,
    max_seq_len=32768, block_pattern=("attn",),
)

SMOKE = dataclasses.replace(
    CONFIG, num_layers=3, d_model=96, num_heads=2, num_kv_heads=2,
    head_dim=48, d_ff=192, vocab_size=512, max_seq_len=128,
)
