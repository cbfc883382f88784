"""Dispatch over the hand-written kernels and their plain versions.

The route follows the tensors' device:
  * a CPU tensor goes to the plain PyTorch version (`ref.py`);
  * a CUDA tensor launches the CUDA kernel, or the wrapper raises.

``backend="torch"`` selects the plain version on any device (the on-card
comparisons use it). There is no environment switch that sends the main path to the plain versions.
`fused_commit_enabled` (``REPRO_NO_FUSED_COMMIT``) only picks between the
fused commit kernel and the op chain, both on the tensors' device.

Each kernel module counts its launches; `launch_counts` reads them and
`reset_launch_counts` zeroes them. The TPU package's `masked_agg` and
`quantize_rows`/`dequantize_rows` kernels are off this path and not ported
yet; their plain versions are in `ref.py`.
"""
from __future__ import annotations

from typing import Dict, Optional

from repro_torch.kernels import cache_update as _cu
from repro_torch.kernels import commit_batch as _cb
from repro_torch.kernels import ref
from repro_torch.kernels import row_delta as _rd
from repro_torch.kernels.backend import fused_commit_enabled

__all__ = [
    "cache_row_update", "commit_batch", "fused_commit_enabled",
    "launch_counts", "reset_launch_counts", "row_delta",
]

_KERNELS = {"cache_row_update": _cu, "row_delta": _rd, "commit_batch": _cb}


def _plain(x, backend: Optional[str]) -> bool:
    if backend not in (None, "torch"):
        raise ValueError(f"unknown backend {backend!r}: None or 'torch'")
    return backend == "torch" or x.device.type == "cpu"


def launch_counts() -> Dict[str, int]:
    return {name: mod.launches for name, mod in _KERNELS.items()}


def reset_launch_counts() -> None:
    for mod in _KERNELS.values():
        mod.launches = 0


def cache_row_update(u, g, c_row, old_scale, new_scale, inv_n, backend=None):
    if _plain(u, backend):
        return ref.cache_row_update_ref(u, g, c_row, old_scale, new_scale,
                                        inv_n)
    return _cu.cache_row_update(u, g, c_row, old_scale, new_scale, inv_n)


def row_delta(g, c_row, old_scale, new_scale, backend=None):
    if _plain(g, backend):
        return ref.row_delta_ref(g, c_row, old_scale, new_scale)
    return _rd.row_delta(g, c_row, old_scale, new_scale)


def commit_batch(G, old_rows, old_s, new_s, valid, vecs, coef, upd_w,
                 lane_a=None, lane_b=None, lane_g=None, backend=None):
    """Fused K-arrival commit: requantize and write the K cache rows, fold
    the masked segment sums into the running-sum vectors and produce the
    model update in one pass. See `ref.commit_batch_ref` for the exact
    semantics; `repro_torch.core.cache.flat_commit_batch` is the
    cache-level wrapper the aggregators call."""
    if _plain(G, backend):
        return ref.commit_batch_ref(G, old_rows, old_s, new_s, valid, vecs,
                                    coef, upd_w, lane_a=lane_a,
                                    lane_b=lane_b, lane_g=lane_g)
    return _cb.commit_batch(G, old_rows, old_s, new_s, valid, vecs, coef,
                            upd_w, lane_a=lane_a, lane_b=lane_b,
                            lane_g=lane_g)

