"""PyTorch / CUDA port of the AttentionLego serving path.

Mirrors the layout of the JAX package (`configs`, `core`, `kernels`,
`models`, `runtime`, `launch`, `data`) module for module, and imports
nothing of it.  Entry points run on the GPU unless the caller asks for the
CPU with ``device="cpu"``; see `repro_torch.device.resolve_device`.
"""
