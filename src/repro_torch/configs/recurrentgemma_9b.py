"""recurrentgemma-9b [hybrid] — RG-LRU + local attention 1:2
(arXiv:2402.19427; unverified)."""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b", family="hybrid",
    num_layers=38, d_model=4096, num_heads=16, num_kv_heads=1,
    head_dim=256, d_ff=12288, vocab_size=256_000,
    activation="geglu", norm="rmsnorm", tie_embeddings=True,
    attn_kind="local", window=2048, lru_width=4096, conv1d_width=4,
    max_seq_len=1_048_576,
    block_pattern=("rglru", "rglru", "attn_local"),
)

SMOKE = dataclasses.replace(
    CONFIG, num_layers=3, d_model=64, num_heads=2, num_kv_heads=1,
    head_dim=32, d_ff=128, vocab_size=256, window=16, lru_width=64,
    max_seq_len=128,
)
