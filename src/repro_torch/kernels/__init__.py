"""Hand-written CUDA kernels of the port (``csrc/``), their plain PyTorch
versions (`ref`) and the device-based dispatch between them (`ops`)."""
