"""Server-side per-client gradient cache — the O(nd) state that makes ACE's
all-client aggregation possible (paper §3.4, Table a.3), with the paper's
8-bit compression (App. F.3.3) as a first-class dtype. Port of
`repro.core.cache`, in its two layouts:

  * flat — `FlatCache`, an (n, d) tensor over raveled params;
  * tree — a structure like the parameters (dicts and lists) whose leaves
    are JAX's ``{"q": (n, *s), "scale": (n,)}`` dicts, one stacked cache
    per parameter leaf (no ``scale`` for a float dtype). An int8 leaf has
    one scale per row over the whole leaf: its writes and reads go through
    `quantize_rows` / `dequantize_rows` on the leaf's ``(rows, numel)``
    view, the same quantizer as the flat cache's.

The layout-generic dispatchers at the bottom (`cache_row`,
`cache_set_row_delta`, `cache_mean`, ...) let one rule serve both layouts.

Quantization is symmetric per-row int8: scale = max|row| / 127. The ACE
incremental rule stays *exact* under quantization because the server
subtracts exactly the dequantized value it previously added: the invariant
``u == mean_i dq(C[i])`` holds to fp rounding.

Unlike the JAX package's immutable caches, these are **updated in place**:
the row writes (`set_row`, `set_row_delta`, `set_rows_delta`,
`flat_commit_batch`, and the tree cache's) scatter into their tensors and
return the same object, so a step never copies the cache. Row indices may
be Python ints or integer tensors on the cache's device; tensor indices
are never read on the host.

The int8 quantizer and dequantizer route through the kernel dispatch
(`kernels.ops.quantize_rows` / `dequantize_rows`): the CUDA kernels for a
CUDA tensor, the plain versions for a CPU tensor or ``backend="torch"``.
`set_row`, the int8 `init_flat_cache`, `rows`/`row`, `dequant` and through
it `mean` and `cache_sum` take them, as does every int8 write and read of
a tree cache; `FlatCache.set_rows_delta` quantizes inline, and
`set_row_delta` is one launch of the `row_delta` kernel.
"""
from __future__ import annotations

import torch

from repro_torch.convert import _rebuild, leaves, tree_map
from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels import ref as kernel_ref
from repro_torch.kernels.backend import resolve_device

INT8_MAX = 127.0
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "int8": torch.int8}


def quantize_rows(x, backend=None):
    """x (d,) or (n, d) -> (q int8 of x's shape, scale () or (n,) f32): the
    `quantize_rows` kernel on a 2-D view. The scale formula is
    `kernels.ref.row_scale`'s — all int8 cache writers share it."""
    q, s = kernel_ops.quantize_rows(x.reshape(-1, x.shape[-1]).contiguous(),
                                    backend=backend)
    return q.reshape(x.shape), s.float().reshape(x.shape[:-1])


def dequantize_rows(q, scale, backend=None):
    """(n, d) int8 codes and (n,) scales -> (n, d) f32."""
    return kernel_ops.dequantize_rows(q, scale, backend=backend)


def row_index(i, device) -> torch.Tensor:
    """Row index (int or integer tensor, any shape) as a 1-D int64 tensor on
    `device` — gathers and scatters take it without a host read."""
    return torch.as_tensor(i, dtype=torch.long, device=device).reshape(-1)


class FlatCache:
    """(n, d) gradient cache; ``data`` is int8 (with per-row ``scale``) or
    float (bf16/f32, ``scale`` unused). Row writes are in place."""

    def __init__(self, data: torch.Tensor, scale: torch.Tensor):
        self.data = data              # (n, d) int8|bf16|f32
        self.scale = scale            # (n,) f32

    @property
    def n(self) -> int:
        return self.data.shape[0]

    @property
    def quantized(self) -> bool:
        return self.data.dtype == torch.int8

    def row(self, i, backend=None):
        """Dequantized f32 row i, (d,)."""
        return self.rows(i, backend)[0]

    def rows(self, idx, backend=None):
        """Dequantized f32 gather of rows ``idx`` (K,) -> (K, d)."""
        idx = row_index(idx, self.data.device)
        r = self.data.index_select(0, idx)
        if self.quantized:
            return dequantize_rows(r, self.scale.index_select(0, idx),
                                   backend)
        return r.float()

    def set_row(self, i, g, backend=None):
        """Write row i (re-quantizing an int8 cache) in place; returns self."""
        i = row_index(i, self.data.device)
        if self.quantized:
            q, s = quantize_rows(g, backend)
            self.data.index_copy_(0, i, q[None])
            self.scale.index_copy_(0, i, s.reshape(1))
        else:
            self.data.index_copy_(0, i, g.to(self.data.dtype)[None])
        return self

    def set_row_delta(self, i, g, backend=None):
        """Write row i in place and return ``(self, delta, old)`` where
        ``old = dq(row_i)`` before the write and ``delta = dq(row_i') − old``
        — the exact change a running sum of dequantized rows sees. The int8
        path is one `row_delta` kernel (the new scale, the old row's
        gather, the swap and the scatter in one launch); float paths are a
        read and a write."""
        i = row_index(i, self.data.device)
        if self.quantized:
            delta, old = kernel_ops.row_delta(self.data, self.scale, i, g,
                                              backend=backend)
            return self, delta, old
        old = self.row(i)
        self.set_row(i, g)
        new = g.to(self.data.dtype).float()
        return self, new - old, old

    def set_rows_delta(self, idx, G, valid=None):
        """Batched `set_row_delta`: write rows ``idx[k] ← G[k]`` in place for
        the lanes where ``valid[k]`` (all lanes when `valid` is None);
        returns ``(self, delta (K, d), old (K, d))``. Indices must be
        pairwise distinct (the K-batch engine's top-k sampling guarantees
        it). Invalid lanes write back their ORIGINAL stored row/scale
        bit-exactly and contribute a zero `delta`."""
        idx = row_index(idx, self.data.device)
        K = idx.shape[0]
        if valid is None:
            valid = torch.ones((K,), dtype=torch.bool, device=idx.device)
        vcol = valid[:, None]
        if self.quantized:
            old_q = self.data.index_select(0, idx)
            old_s = self.scale.index_select(0, idx)
            old = old_q.float() * old_s[:, None]
            new_s = kernel_ref.row_scale(G)
            new_q = torch.clamp(torch.round(G / new_s[:, None]), -INT8_MAX,
                                INT8_MAX).to(torch.int8)
            dq_new = new_q.float() * new_s[:, None]
            delta = torch.where(vcol, dq_new - old, 0.0)
            self.data.index_copy_(0, idx, torch.where(vcol, new_q, old_q))
            self.scale.index_copy_(0, idx,
                                   torch.where(valid, new_s.float(), old_s))
            return self, delta, old
        old_raw = self.data.index_select(0, idx)
        old = old_raw.float()
        new_raw = G.to(self.data.dtype)
        delta = torch.where(vcol, new_raw.float() - old, 0.0)
        self.data.index_copy_(0, idx, torch.where(vcol, new_raw, old_raw))
        return self, delta, old

    def dequant(self, backend=None):
        """(n, d) f32 view."""
        if self.quantized:
            return dequantize_rows(self.data, self.scale, backend)
        return self.data.float()

    def mean(self, mask=None, backend=None):
        """Direct aggregation (paper Alg. 1 line 10 / Alg. a.1 line 7)."""
        rows = self.dequant(backend)
        if mask is None:
            return rows.mean(0)
        m = mask.float()
        return (rows * m[:, None]).sum(0) / torch.clamp(m.sum(), min=1.0)

    def nbytes(self) -> int:
        return (self.data.numel() * self.data.element_size()
                + self.scale.numel() * self.scale.element_size())


# a carry holding a cache round-trips through torch.save / torch.load
torch.serialization.add_safe_globals([FlatCache])


def init_flat_cache(n: int, d: int, dtype: str = "float32", init_rows=None,
                    device=None, backend=None) -> FlatCache:
    """An (n, d) cache of `dtype`, zero or seeded with `init_rows` (on their
    device unless `device` is given). With neither, it goes on the card, or
    raises without one (`resolve_device`)."""
    dt = DTYPES[dtype]
    if init_rows is not None and device is None:
        device = init_rows.device
    device = resolve_device(device)
    if init_rows is not None:
        init_rows = init_rows.to(device)
        if dt == torch.int8:
            return FlatCache(*quantize_rows(init_rows, backend))
        return FlatCache(init_rows.to(dt).clone(),
                         torch.ones((n,), dtype=torch.float32, device=device))
    return FlatCache(torch.zeros((n, d), dtype=dt, device=device),
                     torch.ones((n,), dtype=torch.float32, device=device))


def flat_commit_batch(cache: FlatCache, idx, G, valid, vecs, coef, upd_w,
                      lane_a=None, lane_b=None, lane_g=None, backend=None):
    """The whole K-arrival commit as ONE fused pass: gather the K old rows,
    requantize and scatter the new ones in place, fold the masked segment
    sums into the stacked running-sum vectors ``vecs (R, d)`` via the
    ``coef (R, R+4)`` recombination and emit the ``upd_w``-weighted model
    update — `kernels.ops.commit_batch` (the CUDA kernel on the card, the
    plain version on the CPU).

    Returns ``(cache, vecs' (R, d) f32, update (d,) f32)``. The written rows
    are bit-identical to `FlatCache.set_rows_delta` (valid lanes requantized
    with the same `row_scale`, invalid lanes bit-exact no-ops); only the
    running sums differ from the op chain by f32 reassociation. Lane
    weights must be zero on invalid lanes."""
    idx = row_index(idx, cache.data.device)
    G = G.float()
    old_rows = cache.data.index_select(0, idx)
    if cache.quantized:
        old_s = cache.scale.index_select(0, idx)
        # scale the *sanitized* payloads: an invalid lane's NaN must not
        # poison new_s (its q/scale are never written, but NaN·0 would
        # taint the kernel's products); valid lanes match set_rows_delta's
        # scale formula exactly
        new_s = kernel_ref.row_scale(torch.where(valid[:, None], G, 0.0))
        new_rows, vecs_out, update = kernel_ops.commit_batch(
            G, old_rows, old_s, new_s, valid, vecs, coef, upd_w,
            lane_a=lane_a, lane_b=lane_b, lane_g=lane_g, backend=backend)
        cache.scale.index_copy_(0, idx, torch.where(valid, new_s, old_s))
    else:
        new_rows, vecs_out, update = kernel_ops.commit_batch(
            G, old_rows, None, None, valid, vecs, coef, upd_w,
            lane_a=lane_a, lane_b=lane_b, lane_g=lane_g, backend=backend)
    cache.data.index_copy_(0, idx, new_rows)
    return cache, vecs_out, update


# ---------------------------------------------------------------------------
# Tree cache: one stacked cache per parameter leaf (JAX's tree layout).
# ---------------------------------------------------------------------------

def is_tree_cache_leaf(x) -> bool:
    """A tree-cache *leaf*: the ``{"q": (n, *s), "scale": (n,)}`` dict one
    parameter leaf stacks into (no ``scale`` for a float dtype)."""
    return (isinstance(x, dict) and "q" in x and set(x) <= {"q", "scale"}
            and isinstance(x["q"], torch.Tensor))


def is_tree_cache(x) -> bool:
    """A tree cache: a dict or list whose leaves are tree-cache leaves."""
    if isinstance(x, (torch.Tensor, FlatCache)):
        return False
    first = leaves(x, is_tree_cache_leaf)
    return bool(first) and is_tree_cache_leaf(first[0])


def _tree_device(cache) -> torch.device:
    return leaves(cache, is_tree_cache_leaf)[0]["q"].device


def broadcast_lanes(v, x):
    """`v` (K,) shaped to broadcast over `x` (K, *s)."""
    return v.reshape((-1,) + (1,) * (x.dim() - 1))


def _dequant_leaf(q, scale, backend=None):
    """f32 rows of the int8 codes ``q (K, *s)``: `dequantize_rows` on the
    ``(K, numel)`` view."""
    return dequantize_rows(q.reshape(q.shape[0], -1), scale,
                           backend).reshape(q.shape)


def _quant_leaf(g, backend=None):
    """int8 codes ``(K, *s)`` and scales ``(K,)`` of ``g (K, *s)``, one
    scale per lane over all of its leaf: `quantize_rows` on the ``(K,
    numel)`` view — the scalar scale JAX reduces over every axis but the
    client one is that view's `row_scale`."""
    q, s = quantize_rows(g.float().reshape(g.shape[0], -1), backend)
    return q.reshape(g.shape), s


def init_tree_cache(n: int, grads_like, dtype: str = "float32",
                    init_rows=None, device=None, backend=None):
    """Per-leaf stacked cache ``{"q": (n, *s), "scale": (n,)}`` over the
    leaves of `grads_like` (no ``scale`` for a float dtype), zero or seeded
    with `init_rows` (a grads-like structure whose leaves lead with (n,)).
    An int8 leaf is quantized row by row with the same scale
    `tree_cache_set_row` uses, so a seeded cache equals n row writes. On
    `device` if given, else on the device of the rows (or the template)."""
    dt = DTYPES[dtype]
    src = init_rows if init_rows is not None else grads_like
    if device is None and isinstance(leaves(src)[0], torch.Tensor):
        device = leaves(src)[0].device
    device = resolve_device(device)

    def leaf(g):
        data = torch.zeros((n,) + tuple(g.shape), dtype=dt, device=device)
        if dt == torch.int8:
            return {"q": data, "scale": torch.ones((n,), dtype=torch.float32,
                                                   device=device)}
        return {"q": data}

    def seeded(rows):
        rows = rows.to(device)
        if dt == torch.int8:
            q, s = _quant_leaf(rows, backend)
            return {"q": q, "scale": s}
        return {"q": rows.to(dt).clone()}

    if init_rows is None:
        return tree_map(leaf, grads_like)
    return tree_map(seeded, init_rows)


def tree_cache_reset_(cache):
    """Set every row of a tree cache back to `init_tree_cache`'s zeros
    (scales 1) in place; returns the same cache."""
    for c in leaves(cache, is_leaf=is_tree_cache_leaf):
        c["q"].zero_()
        if "scale" in c:
            c["scale"].fill_(1.0)
    return cache


def tree_cache_rows(cache, idx, backend=None):
    """Dequantized f32 gather of rows ``idx`` (K,): a grads-like structure
    whose leaves lead with (K,)."""
    idx = row_index(idx, _tree_device(cache))

    def leaf(c):
        r = c["q"].index_select(0, idx)
        if "scale" in c:
            return _dequant_leaf(r, c["scale"].index_select(0, idx), backend)
        return r.float()
    return tree_map(leaf, cache, is_leaf=is_tree_cache_leaf)


def tree_cache_row(cache, i, backend=None):
    """Dequantized f32 row i: a grads-like structure."""
    return tree_map(lambda r: r[0], tree_cache_rows(cache, i, backend))


def tree_cache_set_row(cache, i, grads, backend=None):
    """Write row i ← `grads` (re-quantizing each int8 leaf) in place;
    returns the same cache."""
    i = row_index(i, _tree_device(cache))

    def leaf(c, g):
        if "scale" in c:
            q, s = _quant_leaf(g[None], backend)
            c["q"].index_copy_(0, i, q)
            c["scale"].index_copy_(0, i, s)
        else:
            c["q"].index_copy_(0, i, g.to(c["q"].dtype)[None])
    tree_map(leaf, cache, grads, is_leaf=is_tree_cache_leaf)
    return cache


def tree_cache_set_row_delta(cache, i, grads, backend=None):
    """Tree analogue of `FlatCache.set_row_delta`: write row i in place and
    return ``(cache, delta, old)``, grads-like f32 structures with ``old``
    the row before the write and ``delta = dq(row') − old``: the batched
    write over one lane."""
    _, delta, old = tree_cache_set_rows_delta(
        cache, i, tree_map(lambda g: g[None], grads), backend=backend)
    return (cache, tree_map(lambda x: x[0], delta),
            tree_map(lambda x: x[0], old))


def tree_cache_set_rows_delta(cache, idx, grads, valid=None, backend=None):
    """Tree analogue of `FlatCache.set_rows_delta`: `grads` leaves lead with
    (K,); rows ``idx[k] ← grads[k]`` in place for the valid lanes (every
    lane when `valid` is None), each int8 leaf with one scale per lane.
    Invalid lanes write back their stored q/scale bit-exactly and zero
    their `delta`. ``dq(row')`` is formed from the codes just written, so
    it equals the row read back. Returns ``(cache, delta, old)`` with
    (K,)-leading leaves."""
    idx = row_index(idx, _tree_device(cache))
    deltas, olds = [], []

    def keep(mask, new, stored):
        return new if valid is None else torch.where(mask, new, stored)

    def leaf(c, g):
        g = g.float()
        vmask = None if valid is None else broadcast_lanes(valid, g)
        old_raw = c["q"].index_select(0, idx)
        if "scale" in c:
            old_s = c["scale"].index_select(0, idx)
            old = _dequant_leaf(old_raw, old_s, backend)
            q, s = _quant_leaf(g, backend)
            dq_new = _dequant_leaf(q, s, backend)
            c["q"].index_copy_(0, idx, keep(vmask, q, old_raw))
            c["scale"].index_copy_(0, idx, keep(valid, s, old_s))
        else:
            old = old_raw.float()
            new_raw = g.to(c["q"].dtype)
            dq_new = new_raw.float()
            c["q"].index_copy_(0, idx, keep(vmask, new_raw, old_raw))
        deltas.append(keep(vmask, dq_new - old, 0.0))
        olds.append(old)

    tree_map(leaf, cache, grads, is_leaf=is_tree_cache_leaf)
    return (cache, _rebuild(grads, iter(deltas)), _rebuild(grads, iter(olds)))


def _tree_dequant(c, backend=None):
    """A tree-cache leaf's (n, *s) f32 rows."""
    if "scale" in c:
        return _dequant_leaf(c["q"], c["scale"], backend)
    return c["q"].float()


def tree_cache_mean(cache, mask=None, backend=None):
    """(Masked) mean over the client rows, per leaf."""
    def leaf(c):
        rows = _tree_dequant(c, backend)
        if mask is None:
            return rows.mean(0)
        m = mask.float()
        return ((rows * broadcast_lanes(m, rows)).sum(0)
                / torch.clamp(m.sum(), min=1.0))
    return tree_map(leaf, cache, is_leaf=is_tree_cache_leaf)


def tree_cache_sum(cache, mask=None, backend=None):
    """Σ over the dequantized client rows (optionally `mask`-gated), per
    leaf."""
    def leaf(c):
        rows = _tree_dequant(c, backend)
        if mask is None:
            return rows.sum(0)
        return (rows * broadcast_lanes(mask.float(), rows)).sum(0)
    return tree_map(leaf, cache, is_leaf=is_tree_cache_leaf)


def tree_cache_nbytes(cache) -> int:
    return sum(t.numel() * t.element_size() for t in cache_tensors(cache))


# ---------------------------------------------------------------------------
# Layout dispatchers (`repro.core.cache`'s): a `FlatCache` or a tree cache.
# The aggregators call these, so the rules read like the JAX package's.
# ---------------------------------------------------------------------------

def cache_n(cache) -> int:
    """Number of client rows, either layout."""
    if isinstance(cache, FlatCache):
        return cache.n
    return leaves(cache, is_tree_cache_leaf)[0]["q"].shape[0]


def cache_device(cache) -> torch.device:
    """The device a cache of either layout lives on."""
    if isinstance(cache, FlatCache):
        return cache.data.device
    return _tree_device(cache)


def cache_tensors(cache) -> list:
    """The tensors of a cache, which the rules write in place: a
    `FlatCache`'s codes and scales, or each tree-cache leaf's ``q`` then
    its ``scale`` (where it has one) in leaf order; [] for anything that is
    not a cache."""
    if isinstance(cache, FlatCache):
        return [cache.data, cache.scale]
    if not is_tree_cache(cache):
        return []
    return [t for c in leaves(cache, is_tree_cache_leaf)
            for t in ([c["q"], c["scale"]] if "scale" in c else [c["q"]])]


def cache_row(cache, i, backend=None):
    """Dequantized f32 row i: (d,), or a grads-like structure."""
    if isinstance(cache, FlatCache):
        return cache.row(i, backend)
    return tree_cache_row(cache, i, backend)


def cache_rows(cache, idx, backend=None):
    """Dequantized f32 rows ``idx`` (K,): (K, d), or (K,)-leading leaves."""
    if isinstance(cache, FlatCache):
        return cache.rows(idx, backend)
    return tree_cache_rows(cache, idx, backend)


def cache_set_row(cache, i, g, backend=None):
    """Write row i in place (re-quantizing as needed); returns the cache."""
    if isinstance(cache, FlatCache):
        return cache.set_row(i, g, backend)
    return tree_cache_set_row(cache, i, g, backend)


def cache_set_row_delta(cache, i, g, backend=None):
    """Write row i in place -> ``(cache, delta, old)``: ``delta = dq(new) −
    dq(old)`` folds into a running sum and ``old`` is exactly what that sum
    holds for the row (paper Alg. a.5's invariant under int8)."""
    if isinstance(cache, FlatCache):
        return cache.set_row_delta(i, g, backend=backend)
    return tree_cache_set_row_delta(cache, i, g, backend)


def cache_set_rows_delta(cache, idx, G, valid=None, backend=None):
    """Batched `cache_set_row_delta` over K lanes (pairwise distinct
    indices); invalid lanes leave their rows bit-exact and zero their
    delta."""
    if isinstance(cache, FlatCache):
        return cache.set_rows_delta(idx, G, valid)
    return tree_cache_set_rows_delta(cache, idx, G, valid, backend)


def cache_mean(cache, mask=None, backend=None):
    """(Masked) mean over client rows — Alg. 1 line 10 / Alg. a.1 line 7."""
    if isinstance(cache, FlatCache):
        return cache.mean(mask, backend)
    return tree_cache_mean(cache, mask, backend)


def cache_sum(cache, mask=None, backend=None):
    """Σ over dequantized client rows (optionally ``mask``-gated) — the
    one-time O(n·d) seed of the incremental rules' running sums and the
    `Aggregator.resync` exact recompute; never on a per-event hot path."""
    if not isinstance(cache, FlatCache):
        return tree_cache_sum(cache, mask, backend)
    rows = cache.dequant(backend)
    if mask is None:
        return rows.sum(0)
    return (rows * mask.float()[:, None]).sum(0)
