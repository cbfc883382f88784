"""Optimizers and schedules of the port (`repro.optim`'s counterpart)."""
from repro_torch.optim.optim import (Optimizer, adamw, cosine_schedule, sgd,
                                     sgd_momentum, sqrt_nt_schedule)
