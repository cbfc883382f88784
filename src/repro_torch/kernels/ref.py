"""Plain PyTorch versions of the hand-written kernels (the correctness ground
truth), one for each oracle of `repro.kernels.ref`.

Semantics (all f32 accumulation):
  * cache_row_update: fused ACE incremental rule on one cache row
        u' = u + (q(g)·new_scale − c_row·old_scale)·inv_n
        c_row' = q(g)  (int8)
    and set_row_ace: the whole int8 ACE K = 1 step on row j of an int8
    cache (gather, new scale, cache_row_update, scatter), the CUDA
    cache_row_update kernel's function.
  * masked_agg: ACED bounded-delay aggregation over the whole cache
        u = Σ_i (m_i·s_i / max(Σ_i m_i, 1))·C[i]   (rows in order)
  * row_delta: fused cache-row swap for the incremental running-sum rules
        delta  = dq(q(g)) − dq(c_row),   c_row' = q(g)  (int8)
    and set_row_delta: the whole swap of row j of an int8 cache in place
    (gather, new scale, row_delta, scatter), the CUDA row_delta kernel's
    function.
  * quantize_rows / dequantize_rows: symmetric per-row int8.
  * commit_batch: the whole K-arrival server commit as one affine pass —
        rows' = requantized payloads on valid lanes (old rows bit-exact
                elsewhere), running-sum vectors and the model update are
                rows of  mats @ [V; S_Δ; S_A; S_B; S_G].

Rounding contract (shared with the CUDA kernels, required for int8 rows to
match the JAX package bit for bit):
  * the scale is ``max(max|g|, 1e-12) / 127``, a true division on every
    device (on CUDA, PyTorch computes ``tensor / python_float`` as a
    multiply by the f32 reciprocal, which differs in the last bit for some
    rows, so `row_scale` divides by a tensor);
  * quantize with a true division ``g / scale``, never a multiply by the
    reciprocal;
  * ``torch.round`` rounds half to even, like ``jnp.round`` and ``rintf``;
  * clip to ±127, and a NaN quotient to 0;
  * invalid lanes are zeroed before any product.
"""
from __future__ import annotations

import torch

INT8_MAX = 127.0


def row_scale(g: torch.Tensor) -> torch.Tensor:
    m = torch.clamp(torch.amax(torch.abs(g), dim=-1), min=1e-12)
    return m / m.new_full((), INT8_MAX)


def _quant(g, scale):
    """int8 codes of ``g / scale`` (rounded half to even, clipped), in f32. A
    NaN quotient (a NaN element or scale, ±inf/inf) gives 0: the code XLA's
    float→int8 conversion gives the JAX package, and what the CUDA kernels
    write, whatever a device's own cast makes of a NaN."""
    q = torch.round(g / scale)
    return torch.clamp(torch.where(torch.isnan(q), 0.0, q), -INT8_MAX,
                       INT8_MAX)


def cache_row_update_ref(u, g, c_row, old_scale, new_scale, inv_n):
    """u, g (d,) f32; c_row (d,) int8; scalars old_scale, new_scale, inv_n
    -> (u' (d,) f32, c_row' (d,) int8).

    u is updated with the *dequantized* new row (not raw g) so that
    ``u == mean_i dq(C[i])`` stays an exact invariant (paper Alg. a.5
    under F.3.3 compression)."""
    old = c_row.float() * old_scale
    q = _quant(g, new_scale)
    u_new = u + (q * new_scale - old) * inv_n
    return u_new, q.to(torch.int8)


def set_row_ace_ref(data, scale, j, g, u, inv_n):
    """data (n, d) int8, scale (n,) f32, updated in place; j a one-element
    int64 tensor; g (d,) f32; u (d,) f32 or bf16, not written; inv_n a
    Python float -> u' (d,) in u's dtype.

    Row j becomes q(g) with scale `row_scale(g)`, and
    ``u' = u + (q(g)·s' − c·s)·inv_n`` in f32 (u read as f32, the sum
    rounded to u's dtype once): the int8 branch of `ACEIncremental.step`,
    as the JAX package computes it (which leaves a bf16 state's sum in
    f32)."""
    c_row = data.index_select(0, j)[0]
    old_scale = scale.index_select(0, j)[0]
    new_scale = row_scale(g)
    inv = torch.full((), inv_n, dtype=torch.float32, device=u.device)
    u_new, q = cache_row_update_ref(u.float(), g, c_row, old_scale,
                                    new_scale, inv)
    data.index_copy_(0, j, q[None])
    scale.index_copy_(0, j, new_scale.reshape(1))
    return u_new.to(u.dtype)


def row_delta_ref(g, c_row, old_scale, new_scale):
    """g (d,) f32; c_row (d,) int8; scalars old_scale, new_scale
    -> (delta (d,) f32, c_row' (d,) int8).

    ``delta`` is the exact change a running sum of dequantized rows sees
    when the row is overwritten: dq(new) − dq(old)."""
    old = c_row.float() * old_scale
    q = _quant(g, new_scale)
    return q * new_scale - old, q.to(torch.int8)


def set_row_delta_ref(data, scale, j, g):
    """data (n, d) int8, scale (n,) f32, updated in place; j a one-element
    int64 tensor; g (d,) f32 -> (delta (d,) f32, old (d,) f32).

    Row j becomes q(g) with scale `row_scale(g)`; ``old = dq(row_j)`` before
    the write and ``delta = dq(row_j') − old``. The int8 branch of
    `FlatCache.set_row_delta`, as the JAX package computes it."""
    c_row = data.index_select(0, j)[0]
    old_scale = scale.index_select(0, j)[0]
    new_scale = row_scale(g)
    delta, q = row_delta_ref(g, c_row, old_scale, new_scale)
    data.index_copy_(0, j, q[None])
    scale.index_copy_(0, j, new_scale.float().reshape(1))
    # dequantize the old row directly — reconstructing it as
    # q·new_scale − delta would cancel catastrophically when the client's
    # successive gradients differ by orders of magnitude
    return delta, c_row.float() * old_scale


def masked_agg_ref(cache, scales, mask):
    """cache (n, d) int8; scales (n,) f32; mask (n,) bool -> (d,) f32.

    The weights ``m·s / max(Σm, 1)`` are formed first (as the TPU kernel's
    wrapper does) and the rows summed in order 0..n−1 — the CUDA kernel's
    order, so the two agree bit for bit."""
    m = mask.float()
    w = m * scales / torch.clamp(m.sum(), min=1.0)
    acc = torch.zeros(cache.shape[1:], dtype=torch.float32,
                      device=cache.device)
    for i in range(cache.shape[0]):
        acc = acc + w[i] * cache[i].float()
    return acc


def quantize_rows_ref(x):
    """x (n, d) f32 -> (q (n, d) int8, scales (n,) f32)."""
    s = row_scale(x)
    return _quant(x, s[:, None]).to(torch.int8), s


def dequantize_rows_ref(q, s):
    return q.float() * s[:, None]


def commit_batch_ref(G, old_rows, old_s, new_s, valid, vecs, coef, upd_w,
                     lane_a=None, lane_b=None, lane_g=None):
    """The fused K-arrival commit.

    Inputs
      G        (K, d) f32   arriving payloads (invalid lanes may be NaN)
      old_rows (K, d)       gathered cache rows: int8 (with `old_s`/`new_s`
                            (K,) f32 scales) or a float dtype (scales None)
      valid    (K,) bool    guard mask — invalid lanes are perfect no-ops
      vecs     (R, d) f32   stacked running-sum state vectors, R ∈ {1, 2, 3}
      coef     (R, R+4) f32 affine recombination, one row per output vector
      upd_w    (R+4,) f32   the model-update row
      lane_a/b (K,) f32     optional weights on the OLD dequantized rows
                            (zero on invalid lanes); None skips the sum
      lane_g   (K,) f32     optional weights on the (sanitized) payloads

    The basis is ``[vecs_0..vecs_{R-1}, S_Δ, S_A, S_B, S_G]`` with
      S_Δ = Σ_k valid_k·(dq(new_k) − dq(old_k))
      S_A = Σ_k lane_a_k·dq(old_k),  S_B analogous
      S_G = Σ_k lane_g_k·Ĝ_k        (Ĝ = payloads zeroed on invalid lanes)

    Returns ``(new_rows (K, d), vecs' (R, d) f32, update (d,) f32)``.
    Absent lane sums are structural zeros: their `mats` columns are dropped
    instead of materialised."""
    vcol = valid[:, None]
    G = G.float()
    # single sanitization point: quarantined lanes may carry NaN/inf, and
    # every downstream product must see a finite 0 there instead
    Gs = torch.where(vcol, G, 0.0)
    if old_s is not None:
        old = old_rows.float() * old_s[:, None]
        q = _quant(Gs, new_s[:, None])
        new_rows = torch.where(vcol, q.to(torch.int8), old_rows)
        dq_new = q * new_s[:, None]
    else:
        old = old_rows.float()
        stored = Gs.to(old_rows.dtype)
        new_rows = torch.where(vcol, stored, old_rows)
        dq_new = stored.float()

    # Every sum runs in a fixed order — the lane sums over k = 0..K-1, the
    # recombination over the basis columns in order — the order the CUDA
    # kernel's threads use, so kernel and plain version agree bit for bit.
    sums = {"d": (valid.float(), dq_new - old)}
    for key, lane, rows in (("a", lane_a, old), ("b", lane_b, old),
                            ("g", lane_g, Gs)):
        if lane is not None:
            sums[key] = (lane.float(), rows)
    basis = {}
    for key, (w, rows) in sums.items():
        acc = torch.zeros_like(rows[0])
        for k in range(rows.shape[0]):
            # S_Δ adds only valid lanes' terms (a where, never 0·NaN)
            term = (torch.where(valid[k], rows[k], 0.0) if key == "d"
                    else w[k] * rows[k])
            acc = acc + term
        basis[key] = acc
    R = vecs.shape[0]
    mats = torch.cat([coef, upd_w[None]], 0).float()
    cols = [(c, vecs[c].float()) for c in range(R)] + [(R, basis["d"])]
    cols += [(R + 1 + i, basis[key]) for i, key in enumerate("abg")
             if key in basis]
    out = torch.zeros((R + 1,) + vecs.shape[1:], dtype=torch.float32,
                      device=vecs.device)
    for c, col in cols:
        out = out + mats[:, c:c + 1] * col[None]
    return new_rows, out[:-1], out[-1]
