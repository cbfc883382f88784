"""Dispatch over the hand-written kernels and their plain versions.

The route follows the tensors' device:
  * a CPU tensor goes to the plain PyTorch version (`ref.py`);
  * a CUDA tensor launches the CUDA kernel, or the wrapper raises.

``backend="torch"`` selects the plain version on any device (the on-card
comparisons use it). There is no environment switch that sends the main path to the plain versions.
`fused_commit_enabled` (``REPRO_NO_FUSED_COMMIT``) only picks between the
fused commit kernel and the op chain, both on the tensors' device.

Every TPU kernel of the JAX package has its kernel here: `commit_batch`,
`row_delta`, `cache_row_update`, `masked_agg`, `quantize_rows` and
`dequantize_rows`. Each counts its launches; `launch_counts` reads them and
`reset_launch_counts` zeroes them. A replayed CUDA graph launches kernels
that no wrapper sees: the engine that replays one adds the counts its
capture recorded with `add_launch_counts`, so the counters count the
launches that ran.
"""
from __future__ import annotations

from typing import Dict, Optional

from repro_torch.kernels import cache_update as _cu
from repro_torch.kernels import commit_batch as _cb
from repro_torch.kernels import masked_agg as _ma
from repro_torch.kernels import quant as _q
from repro_torch.kernels import ref
from repro_torch.kernels import row_delta as _rd
from repro_torch.kernels.backend import fused_commit_enabled

__all__ = [
    "add_launch_counts", "cache_row_update", "commit_batch",
    "dequantize_rows", "fused_commit_enabled", "launch_counts", "masked_agg",
    "quantize_rows", "reset_launch_counts", "row_delta",
]

# kernel name -> (module, name of its launch counter)
_KERNELS = {"cache_row_update": (_cu, "launches"),
            "row_delta": (_rd, "launches"),
            "commit_batch": (_cb, "launches"),
            "masked_agg": (_ma, "launches"),
            "quantize_rows": (_q, "quantize_launches"),
            "dequantize_rows": (_q, "dequantize_launches")}


def _plain(x, backend: Optional[str]) -> bool:
    if backend not in (None, "torch"):
        raise ValueError(f"unknown backend {backend!r}: None or 'torch'")
    return backend == "torch" or x.device.type == "cpu"


def launch_counts() -> Dict[str, int]:
    return {name: getattr(mod, attr) for name, (mod, attr) in _KERNELS.items()}


def reset_launch_counts() -> None:
    for mod, attr in _KERNELS.values():
        setattr(mod, attr, 0)


def add_launch_counts(counts: Dict[str, int], times: int = 1) -> None:
    """Add ``times × counts[name]`` to each named kernel's counter (a
    negative `times` takes back what a graph capture counted but did not
    launch)."""
    for name, k in counts.items():
        mod, attr = _KERNELS[name]
        setattr(mod, attr, getattr(mod, attr) + k * times)


def cache_row_update(data, scale, j, g, u, inv_n, backend=None):
    """The int8 ACE step on row ``j`` (a one-element int64 tensor) of the
    int8 cache ``(data, scale)``: the row becomes ``q(g)`` in place and
    ``u' = u + (dq(row_j') − dq(row_j))·inv_n`` comes back in u's dtype
    (f32 or bf16); u itself is not written."""
    if _plain(data, backend):
        return ref.set_row_ace_ref(data, scale, j, g, u, inv_n)
    return _cu.cache_row_update(data, scale, j, g, u, inv_n)


def row_delta(data, scale, j, g, backend=None):
    """Swap row ``j`` (a one-element int64 tensor) of the int8 cache
    ``(data, scale)`` for ``q(g)`` in place -> ``(delta, old)``, both (d,)
    f32: ``old = dq(row_j)`` before, ``delta = dq(row_j') − old``."""
    if _plain(data, backend):
        return ref.set_row_delta_ref(data, scale, j, g)
    return _rd.row_delta(data, scale, j, g)


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


def masked_agg(cache, scales, mask, backend=None):
    """``Σ_i m_i·s_i·C[i] / max(Σm, 1)`` over an (n, d) int8 cache."""
    if _plain(cache, backend):
        return ref.masked_agg_ref(cache, scales, mask)
    return _ma.masked_agg(cache, scales, mask)


def quantize_rows(x, backend=None):
    """(n, d) f32 -> (q (n, d) int8, scales (n,) f32), per-row symmetric."""
    if _plain(x, backend):
        return ref.quantize_rows_ref(x)
    return _q.quantize_rows(x)


def dequantize_rows(q, s, backend=None):
    """(n, d) int8 codes and (n,) scales -> (n, d) f32."""
    if _plain(q, backend):
        return ref.dequantize_rows_ref(q, s)
    return _q.dequantize_rows(q, s)
