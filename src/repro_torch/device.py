"""Device policy of the port's entry points."""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device an entry point runs on.

    With no `device` it is the current CUDA device; when there is none the
    call raises instead of falling back to the CPU, which a caller must ask
    for by name (``device="cpu"``, as the tests do)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)
