"""Checkpoints of parameter structures and of the chunked runner's carry —
the port of `repro.checkpoint.checkpoint`, in its file format.

A checkpoint is an ``.npz`` with one array per leaf, keyed by the leaf's
path as the JAX package writes it: ``['k']`` for a dict key, ``[i]`` for a
list or tuple index and ``.name`` for a NamedTuple field or a
`FlatCache`'s ``data`` / ``scale``, joined with ``/`` (dicts by sorted key,
as JAX flattens them). So a checkpoint either package writes, the other
restores. Leaves are tensors (any device; CUDA tensors are copied to the
host once per save), numpy arrays or Python numbers. A bfloat16 leaf is
stored as float32 (numpy has no bfloat16 without `ml_dtypes`): the value
is exact, and restore casts it back bit for bit (the JAX package's restore
casts it the same way); a bfloat16 leaf the JAX package wrote (its raw 16
bits) restores too. Restore casts every leaf to its template leaf's dtype
and puts it on that leaf's device.

Crash safety: a payload is written to ``<path>.tmp`` in the target
directory, fsynced, then published with `os.replace`, so a reader never
sees a half-written checkpoint under the final name. Each payload has a
``<name>.sha256`` sidecar (the hex digest of the published bytes, itself
written atomically); `verify_checkpoint` checks it, and
`restore_train_checkpoint` walks the checkpoints newest first, skipping
any that fail verification or parsing, so a run killed mid-save (or a
corrupted file) falls back to the last good checkpoint. Saves retry with
exponential backoff on `OSError`.

``<prefix>_structure.json`` lists the leaf keys with their shapes and
dtypes (the JAX package writes its treedef's repr there, which the port
cannot make); neither package's restore reads it: the template gives the
structure.
"""
from __future__ import annotations

import hashlib
import json
import os
import re
import time
import warnings
from typing import Any, Callable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.cache import FlatCache


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(node) -> Optional[List[Tuple[str, Any]]]:
    """``[(path piece, child), ...]`` of a container in JAX's order, or
    None for a leaf. None (a pytree with no leaves) has no children."""
    if node is None:
        return []
    if isinstance(node, dict):
        return [(f"[{k!r}]", node[k]) for k in sorted(node)]
    if isinstance(node, FlatCache):
        return [(".data", node.data), (".scale", node.scale)]
    if _is_namedtuple(node):
        return [(f".{f}", getattr(node, f)) for f in node._fields]
    if isinstance(node, (list, tuple)):
        return [(f"[{i}]", x) for i, x in enumerate(node)]
    return None


def _paths(tree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """``(key, leaf)`` for every leaf of `tree`, keyed as the JAX package
    keys it (`_flatten_with_paths`)."""
    kids = _children(tree)
    if kids is None:
        yield prefix, tree
        return
    for piece, child in kids:
        yield from _paths(child, f"{prefix}/{piece}" if prefix else piece)


def _rebuild(template, fn: Callable, prefix: str = ""):
    """`template`'s structure with each leaf replaced by ``fn(key, leaf)``."""
    kids = _children(template)
    if kids is None:
        return fn(prefix, template)
    new = [_rebuild(child, fn, f"{prefix}/{piece}" if prefix else piece)
           for piece, child in kids]
    if template is None:
        return None
    if isinstance(template, dict):
        return dict(zip(sorted(template), new))
    if isinstance(template, FlatCache):
        return FlatCache(*new)
    if _is_namedtuple(template):
        return type(template)(*new)
    return type(template)(new)


def _host(leaf) -> np.ndarray:
    """A leaf as a host numpy array; bfloat16 as its exact float32."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()
    return np.asarray(leaf)


def _flatten_with_paths(tree) -> dict:
    return {key: _host(leaf) for key, leaf in _paths(tree)}


def _describe(leaf) -> dict:
    if isinstance(leaf, torch.Tensor):
        return {"shape": list(leaf.shape),
                "dtype": str(leaf.dtype).replace("torch.", "")}
    a = np.asarray(leaf)
    return {"shape": list(a.shape), "dtype": a.dtype.name}


def _sidecar(path: str) -> str:
    return path + ".sha256"


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def _atomic_write_bytes(path: str, data: bytes) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def verify_checkpoint(path: str) -> bool:
    """True iff `path` exists and matches its ``.sha256`` sidecar. A
    checkpoint without a sidecar (a legacy file) verifies by parsing."""
    if not os.path.isfile(path):
        return False
    side = _sidecar(path)
    if os.path.isfile(side):
        try:
            with open(side) as f:
                want = f.read().strip()
            return _sha256(path) == want
        except OSError:
            return False
    try:
        with np.load(path) as data:
            data.files
        return True
    except Exception:  # any parse failure means "not a checkpoint"
        return False


def save_checkpoint(directory: str, step: int, tree: Any, *, prefix="ckpt",
                    keep: int = 3, retries: int = 3,
                    backoff: float = 0.05) -> str:
    """Atomically persist `tree` as ``<prefix>_<step>.npz`` and its checksum
    sidecar; keep the newest `keep` checkpoints. The payload is published
    before its sidecar, so a crash between the two leaves a file that still
    verifies by parsing. An `OSError` retries up to `retries` times with
    exponential backoff."""
    directory = os.fspath(directory)
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"{prefix}_{step:08d}.npz")
    tmp = path + ".tmp"
    flat = _flatten_with_paths(tree)
    for attempt in range(retries + 1):
        try:
            # a file handle, not a path: np.savez would append ".npz" to a
            # bare path and break the os.replace pairing
            with open(tmp, "wb") as f:
                np.savez(f, **flat)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
            _atomic_write_bytes(_sidecar(path),
                                (_sha256(path) + "\n").encode())
            break
        except OSError:
            try:
                if os.path.isfile(tmp):
                    os.remove(tmp)
            except OSError:
                pass
            if attempt == retries:
                raise
            time.sleep(backoff * (2 ** attempt))
    struct = {key: _describe(leaf) for key, leaf in _paths(tree)}
    with open(os.path.join(directory, f"{prefix}_structure.json"), "w") as f:
        json.dump(struct, f)
    # rotate (sidecars travel with their payloads)
    ckpts = sorted(p for p in os.listdir(directory)
                   if p.startswith(prefix + "_") and p.endswith(".npz"))
    for old in ckpts[:-keep]:
        for stale in (os.path.join(directory, old),
                      _sidecar(os.path.join(directory, old))):
            if os.path.isfile(stale):
                os.remove(stale)
    return path


def _all_steps(directory: str, prefix: str) -> List[int]:
    directory = os.fspath(directory)
    if not os.path.isdir(directory):
        return []
    return sorted(int(m.group(1)) for p in os.listdir(directory)
                  if (m := re.match(rf"{prefix}_(\d+)\.npz$", p)))


def latest_step(directory: str, prefix="ckpt",
                verified: bool = False) -> Optional[int]:
    """Newest checkpoint step, or None. With ``verified=True``, the newest
    step whose payload passes `verify_checkpoint`."""
    steps = _all_steps(directory, prefix)
    if verified:
        steps = [s for s in steps if verify_checkpoint(
            os.path.join(os.fspath(directory), f"{prefix}_{s:08d}.npz"))]
    return max(steps) if steps else None


def _like(arr: np.ndarray, leaf):
    """`arr` as `leaf`'s kind: a tensor of its dtype on its device, else a
    numpy array of its dtype."""
    if isinstance(leaf, torch.Tensor):
        if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
            # the JAX package's bfloat16 leaf: ml_dtypes' type, which numpy
            # writes as its raw 16 bits
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr)
        return t.to(device=leaf.device, dtype=leaf.dtype)
    return arr.astype(np.asarray(leaf).dtype)


def restore_checkpoint(directory: str, step: int, target: Any, *,
                       prefix="ckpt") -> Any:
    """Restore into the structure of `target`, whose leaves give each
    restored leaf its shape (checked), dtype and device."""
    path = os.path.join(os.fspath(directory), f"{prefix}_{step:08d}.npz")
    with np.load(path) as data:
        def leaf(key, like):
            arr = data[key]
            if arr.shape != tuple(np.shape(like)):
                raise ValueError(f"{key}: checkpoint shape {arr.shape}, "
                                 f"template {tuple(np.shape(like))}")
            return _like(arr, like)
        return _rebuild(target, leaf)


# ---------------------------------------------------------------------------
# Train checkpoints: the chunked runner's carry is the whole protocol state
# (model, rule state with its caches, the history ring, the stream cursor
# ``e``, guard counters and eval snapshots), so a resumed run continues the
# server rule where it stopped.
# ---------------------------------------------------------------------------

_TRAIN_PREFIX = "afl"


def save_train_checkpoint(directory: str, event: int, carry: Any, *,
                          keep: int = 3) -> str:
    """Persist the chunked runner's carry at event-stream position `event`
    (a chunk boundary of `repro_torch.launch.train`)."""
    return save_checkpoint(directory, event, {"carry": carry},
                           prefix=_TRAIN_PREFIX, keep=keep)


def restore_train_checkpoint(directory: str, carry_template: Any):
    """-> (carry, event) from the newest verified train checkpoint, or
    ``(carry_template, 0)`` when none is left. `carry_template` is a fresh
    carry (``runner.init(...)``): the donor of shapes, dtypes and devices.

    A checkpoint that fails its checksum or does not parse or restore (a
    run killed mid-save, a corrupted disk) is skipped with a
    `RuntimeWarning`, and the walk falls back to the next newest."""
    for step in reversed(_all_steps(directory, _TRAIN_PREFIX)):
        path = os.path.join(os.fspath(directory),
                            f"{_TRAIN_PREFIX}_{step:08d}.npz")
        if not verify_checkpoint(path):
            warnings.warn(f"skipping corrupt checkpoint {path} "
                          "(checksum/parse failure)", RuntimeWarning)
            continue
        try:
            payload = restore_checkpoint(directory, step,
                                         {"carry": carry_template},
                                         prefix=_TRAIN_PREFIX)
        except Exception as err:  # truncated or unreadable despite checksum
            warnings.warn(f"skipping unrestorable checkpoint {path}: {err}",
                          RuntimeWarning)
            continue
        return payload["carry"], step
    return carry_template, 0
