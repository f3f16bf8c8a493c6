"""phi-3-vision-4.2b [vlm] — phi3-mini backbone + CLIP frontend STUB
(input_specs feeds precomputed patch embeddings)
(hf:microsoft/Phi-3-vision-128k-instruct; hf)."""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b", family="vlm",
    num_layers=32, d_model=3072, num_heads=32, num_kv_heads=32,
    head_dim=96, d_ff=8192, vocab_size=32064,
    activation="swiglu", norm="rmsnorm",
    max_seq_len=32768, block_pattern=("attn",), num_image_patches=576,
)

SMOKE = dataclasses.replace(
    CONFIG, num_layers=3, d_model=64, num_heads=2, num_kv_heads=2,
    head_dim=32, d_ff=128, vocab_size=256, max_seq_len=128,
    num_image_patches=4,
)
