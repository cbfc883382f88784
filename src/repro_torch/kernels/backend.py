"""Device and kernel policy of the port, in one place: which device an entry
point runs on, what a CUDA kernel wrapper accepts, and whether the K-arrival
step takes the fused commit kernel or the op chain."""
from __future__ import annotations

import os
from typing import Optional, Sequence

import torch

_TRUTHY = ("1", "true", "on", "yes")


def fused_commit_enabled(override: Optional[bool] = None) -> bool:
    """Resolve the fused-commit wiring flag (aggregators' ``fused_commit``
    field): explicit `override` wins, else on unless ``REPRO_NO_FUSED_COMMIT``
    is truthy. Off routes `step_batch` through the op chain
    (`cache_set_rows_delta` + masked segment sums). Both run on the device
    of the tensors they are given; neither sends work to the plain
    versions."""
    if override is not None:
        return bool(override)
    return os.environ.get("REPRO_NO_FUSED_COMMIT",
                          "").strip().lower() not in _TRUTHY


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller passes
    ``device="cpu"``. Without a card and without an explicit CPU request it
    raises — an entry point never carries on on the CPU by itself."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the GPU; pass device='cpu' "
                "to run the plain PyTorch versions on the CPU")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not "
                           "available")
    return dev


def cuda_operand(x, name: str, dtype: torch.dtype, shape: Sequence[int],
                 device: Optional[torch.device] = None) -> torch.Tensor:
    """Check one operand of a CUDA kernel wrapper: a contiguous CUDA tensor
    of the given dtype and shape (on `device` when given). Raises on
    anything the kernel does not take."""
    if not isinstance(x, torch.Tensor) or x.device.type != "cuda":
        raise TypeError(f"{name}: expected a CUDA tensor, got "
                        f"{getattr(x, 'device', type(x).__name__)}")
    if device is not None and x.device != device:
        raise ValueError(f"{name}: on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name}: dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(x.shape)}, expected "
                         f"{tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
    return x


def cuda_scalar(x, name: str, device: torch.device) -> torch.Tensor:
    """A 0-d f32 CUDA operand on `device`; a Python number is written there
    by a fill, not a host copy (a kernel reads its scalars through
    pointers)."""
    if not isinstance(x, torch.Tensor):
        x = torch.full((), float(x), dtype=torch.float32, device=device)
    return cuda_operand(x.reshape(()), name, torch.float32, (), device)


def stream_handle(device: torch.device) -> int:
    """PyTorch's current CUDA stream on `device`, as the raw handle a C
    entry takes."""
    return torch.cuda.current_stream(device).cuda_stream
