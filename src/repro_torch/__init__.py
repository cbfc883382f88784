"""PyTorch/CUDA port of the AFL server (`repro`), module for module: the
staleness and event engines (`repro_torch.core`), their hand-written Hopper
kernels (`repro_torch.kernels`), the datasets (`repro_torch.data`), and the
real models — configurations (`repro_torch.configs`), the transformer of
the attention-only decoders (`repro_torch.models`) and the optimizers
(`repro_torch.optim`). Entry points run on the GPU unless the caller
passes ``device="cpu"``."""
