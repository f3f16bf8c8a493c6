"""xlstm-1.3b [ssm] — sLSTM + mLSTM blocks, ratio 7:1 (arXiv:2405.04517;
unverified).  No softmax attention: the paper's Score / Softmax modules do
not apply; its PIM linears do."""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b", family="ssm",
    num_layers=48, d_model=2048, num_heads=4, num_kv_heads=4,
    d_ff=0, vocab_size=50304,
    activation="gelu", norm="rmsnorm", pos="none", attn_kind="none",
    max_seq_len=1_048_576,
    block_pattern=("mlstm",) * 7 + ("slstm",),
)

SMOKE = dataclasses.replace(
    CONFIG, num_layers=4, d_model=64, num_heads=2, num_kv_heads=2,
    vocab_size=256, max_seq_len=128, block_pattern=("mlstm", "slstm"),
)
