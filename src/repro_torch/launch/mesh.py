"""Mesh construction — the port of `repro.launch.mesh`.

PyTorch runs one process per device, so a mesh is a
`torch.distributed.device_mesh.DeviceMesh` over the ranks of the
initialised process group, its dims named ``("data", "model")`` (or
``("pod", "data", "model")``). Functions, not constants: importing this
module touches no process group. The mesh lives on ``cuda`` when the group
is NCCL's (its ranks hold cards) and on ``cpu`` otherwise (``gloo``;
`repro_torch.sharding.rules.build_mesh`)."""
from __future__ import annotations

import torch.distributed as dist

from repro_torch.sharding.rules import build_mesh


def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def make_production_mesh(*, multi_pod: bool = False):
    """(data=16, model=16) over 256 ranks, or (pod=2, data=16, model=16)
    over 512 with `multi_pod`; any other world raises."""
    want = 512 if multi_pod else 256
    if _world() != want:
        raise ValueError(f"the production mesh needs a world of {want} "
                         f"ranks, not {_world()}")
    if multi_pod:
        return build_mesh((2, 16, 16), ("pod", "data", "model"))
    return build_mesh((16, 16), ("data", "model"))


def make_host_mesh(*, model: int = 1):
    """A ``(world // model, model)`` ``("data", "model")`` mesh over every
    rank of the process group, for smoke runs."""
    n = _world()
    if n % model != 0:
        raise ValueError(f"model={model} does not divide the world of {n} "
                         "ranks")
    return build_mesh((n // model, model), ("data", "model"))
