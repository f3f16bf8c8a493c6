"""Architecture registry of the port: the archs whose serving path is ported."""
from repro_torch.configs import (
    dbrx_132b,
    deepseek_moe_16b,
    gemma_7b,
    internlm2_1_8b,
    mistral_large_123b,
    phi_3_vision_4_2b,
    qwen2_72b,
    recurrentgemma_9b,
    whisper_tiny,
    xlstm_1_3b,
)
from repro_torch.configs.base import (  # noqa: F401
    LUTSoftmaxConfig, ModelConfig, MoEConfig, PIMConfig, TrainConfig,
)

_MODULES = {
    "mistral-large-123b": mistral_large_123b,
    "internlm2-1.8b": internlm2_1_8b,
    "qwen2-72b": qwen2_72b,
    "deepseek-moe-16b": deepseek_moe_16b,
    "dbrx-132b": dbrx_132b,
    "gemma-7b": gemma_7b,
    "recurrentgemma-9b": recurrentgemma_9b,
    "phi-3-vision-4.2b": phi_3_vision_4_2b,
    "whisper-tiny": whisper_tiny,
    "xlstm-1.3b": xlstm_1_3b,
}

ARCH_NAMES = tuple(_MODULES)


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; the port serves {ARCH_NAMES}")
    mod = _MODULES[arch]
    return mod.SMOKE if smoke else mod.CONFIG
