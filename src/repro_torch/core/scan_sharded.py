"""Sharded staleness scan — the sampled-staleness engine
(`repro_torch.core.scan_staleness`) laid out over a ``("data", "model")``
mesh, the port of `repro.core.scan_sharded`.

ACE/ACED pay for their participation-imbalance robustness with an O(n·d)
per-client cache (paper Table a.3), and the engine adds a
``(tau_max+1, d)`` model-history ring and an ``(n_marks, d)`` snapshot
buffer. On one card those buffers bound the reachable (n_clients ×
model-size) corner of the Fig. 2/3 sweeps; this module splits them so the
same run spans several:

  * **aggregator cache** ``(n_clients, d)`` — client rows over ``data``,
    features over ``model`` (logical axes ``cache_clients``/``cache_d``,
    `repro_torch.sharding.rules`);
  * **ring buffer** ``(tau_max+1, d)`` and **snapshot buffer**
    ``(n_marks, d)`` — slots replicated, features over ``model``;
  * everything else — the model, the running sums, the payloads, the O(n)
    tensors — replicated.

PyTorch has no single controller to partition one program, so the port
runs one process per rank under `torch.distributed`, every rank the same
tick on the same streams. The server state lives in blocks
(`repro_torch.core.cache.BlockedFlatCache`): a rank holds its block only,
and the cache's methods gather the K rows a tick reads (an all-reduce over
``data`` of the owners' rows, the others adding exact zeros; an all-gather
over ``model``) and the sums over clients (an all-reduce over ``data``),
so one implementation of each rule (`Aggregator.step`) serves the host
references, one card and the mesh. Only O(K·d) numbers move a tick; the
blocks never do. The K rows of a commit are gathered whole onto every rank
and the `commit_batch` kernel runs on them replicated; with whole rows a
rank's block takes the int8 row kernels (`row_delta`, `cache_row_update`)
on its own rows, a non-owner on a spare row. Every rank launches the same
kernels and collectives, so the tick is captured as a CUDA graph on the
card as the unsharded one is.

Equivalence contract (JAX's): sharded and unsharded runs consume identical
streams and differ only by reduction order, so trajectories agree within
1e-5 — tests/test_torch_scan_sharded.py holds the port's sharded runs on
CPU ``gloo`` ranks against its unsharded runs and against JAX's.

Usage, one process a rank (``torchrun --nproc-per-node N ...``)::

    torch.distributed.init_process_group("nccl")   # or "gloo" on the CPU
    mesh = staleness_mesh()                  # (data, model) over the world
    runner = make_sharded_staleness_runner(mesh=mesh, grad_fn=..., ...)
    # or: run_staleness_scan / _seeds / _grid(..., mesh=mesh)
"""
from __future__ import annotations

from typing import Optional

import torch.distributed as dist

from repro_torch.core.scan_staleness import (make_chunked_staleness_runner,
                                             make_staleness_runner)
from repro_torch.sharding.rules import build_mesh


def staleness_mesh(*, model: Optional[int] = None):
    """A ``("data", "model")`` mesh over every rank of the process group,
    or None when no group is initialised or it has one rank (callers then
    take the unsharded runner, as JAX's returns None on one device).

    `model` defaults to 2 when the world is even (features of the
    cache/ring/snapshot buffers split once, client rows take the rest) and 1
    otherwise; pass it to bias toward feature sharding for large models.
    The client axis gets the larger factor because the O(n·d) cache
    dominates state and n_clients is the axis that scales with fleet
    size."""
    if not dist.is_initialized():
        return None
    n = dist.get_world_size()
    if n < 2:
        return None
    if model is None:
        model = 2 if n % 2 == 0 else 1
    if n % model != 0:
        raise ValueError(f"model={model} does not divide the world of {n} "
                         "ranks")
    return build_mesh((n // model, model), ("data", "model"))


def make_sharded_staleness_runner(*, mesh, **kwargs):
    """The sharded runner: `make_staleness_runner(mesh=mesh, **kwargs)`,
    with the unsharded runner's call signature and results (replicated on
    every rank). Every rank of `mesh` must call it with the same arguments.
    On the card the tick, collectives included, is captured as one CUDA
    graph; a capture that fails raises."""
    if mesh is None:
        raise ValueError("make_sharded_staleness_runner needs a mesh; use "
                         "make_staleness_runner for single-device runs")
    return make_staleness_runner(mesh=mesh, **kwargs)


def make_sharded_chunked_staleness_runner(*, mesh, **kwargs):
    """The chunked runner (`ChunkedStalenessRunner`) over `mesh`: the
    checkpointable executor `repro_torch.launch.train` drives on more than
    one rank. It exists for symmetry and the explicit mesh-required
    contract."""
    if mesh is None:
        raise ValueError("make_sharded_chunked_staleness_runner needs a "
                         "mesh; use make_chunked_staleness_runner for "
                         "single-device runs")
    return make_chunked_staleness_runner(mesh=mesh, **kwargs)
