"""PyTorch/CUDA port of the AFL server (`repro`), module for module: the
flat-cache staleness engine (`repro_torch.core`), its hand-written Hopper
kernels (`repro_torch.kernels`) and the datasets (`repro_torch.data`).
Entry points run on the GPU unless the caller passes ``device="cpu"``."""
