"""whisper-tiny [audio] — enc-dec backbone; conv frontend is a STUB that
feeds precomputed frame embeddings (arXiv:2212.04356; hf:openai/whisper-tiny)."""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny", family="audio",
    num_layers=4, d_model=384, num_heads=6, num_kv_heads=6,
    head_dim=64, d_ff=1536, vocab_size=51865,
    activation="gelu", norm="layernorm", pos="absolute",
    is_encoder_decoder=True, num_encoder_layers=4, encoder_seq_len=1500,
    max_seq_len=32768, block_pattern=("xattn",),
)

SMOKE = dataclasses.replace(
    CONFIG, num_layers=2, num_encoder_layers=2, d_model=64, num_heads=2,
    num_kv_heads=2, head_dim=32, d_ff=128, vocab_size=256,
    encoder_seq_len=12, max_seq_len=128,
)
