"""Architecture registry of the port: the archs whose serving path is ported."""
from repro_torch.configs import internlm2_1_8b
from repro_torch.configs.base import (  # noqa: F401
    LUTSoftmaxConfig, ModelConfig, MoEConfig, PIMConfig,
)

_MODULES = {
    "internlm2-1.8b": internlm2_1_8b,
}

ARCH_NAMES = tuple(_MODULES)


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; the port serves {ARCH_NAMES}")
    mod = _MODULES[arch]
    return mod.SMOKE if smoke else mod.CONFIG
