"""Hand-written CUDA kernels of the port, each with its plain PyTorch
version beside it.  Sources are in `csrc/`; `_build` compiles them at the
first launch."""
