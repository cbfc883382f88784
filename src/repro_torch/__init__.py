"""PyTorch/CUDA port of the AFL server (`repro`), module for module: the
staleness and event engines and the AFL train step (`repro_torch.core`),
their hand-written Hopper kernels (`repro_torch.kernels`), the datasets
(`repro_torch.data`), the real models — configurations
(`repro_torch.configs`), the transformers (`repro_torch.models`) and the
optimizers (`repro_torch.optim`) — crash-safe checkpoints
(`repro_torch.checkpoint`), the train and serve drivers with the
analytic FLOP counts and the production dry run (`repro_torch.launch`), the
sharding rules (`repro_torch.sharding`) and the tracecheck analyzer
(`repro_torch.analysis`). Entry points run on the GPU unless the caller
passes ``device="cpu"``."""
