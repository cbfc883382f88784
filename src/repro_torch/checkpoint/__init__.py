"""Crash-safe checkpoints of parameter structures and of the chunked
runner's carry, in the JAX package's file format (`repro.checkpoint`'s
counterpart)."""
from repro_torch.checkpoint.checkpoint import (latest_step,  # noqa: F401
                                               restore_checkpoint,
                                               restore_train_checkpoint,
                                               save_checkpoint,
                                               save_train_checkpoint,
                                               verify_checkpoint)
