"""Mamba2 / SSD (state-space duality, arXiv:2405.21060) block — a port of
`repro.models.ssm`.

Training/prefill uses the chunked SSD algorithm: the intra-chunk quadratic
("attention-like") term as batched matrix products, and the inter-chunk
recurrent state passed by a Python loop over the chunks (where JAX scans).
Decode is the O(1) single-step recurrence on a persistent (H, P, N) state
plus a depthwise-conv ring cache. The JAX package's SSD is plain JAX (no
Pallas kernel), and so is this one plain PyTorch. `A_log`, `D` and
`dt_bias` are float32 whatever the config's dtype."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init, rms_norm
from repro_torch.sharding.rules import (guarded_spec, is_placed,
                                        row_parallel, shard)


def mamba_init(generator, cfg, dtype, device=None):
    d = cfg.d_model
    di, N, H, G, K = (cfg.d_inner, cfg.ssm_state, cfg.ssm_heads,
                      cfg.ssm_groups, cfg.ssm_conv)
    conv_ch = di + 2 * G * N
    dev = device or generator.device
    in_proj = dense_init(generator, d, 2 * di + 2 * G * N + H, dtype,
                         device=device)
    conv_w = torch.randn((K, conv_ch), generator=generator,
                         device=generator.device) * 0.1
    return {
        "in_proj": in_proj,
        "conv_w": conv_w.to(device=dev, dtype=dtype),
        "conv_b": torch.zeros((conv_ch,), dtype=dtype, device=dev),
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, device=dev)),
        "D": torch.ones((H,), dtype=torch.float32, device=dev),
        "dt_bias": torch.full((H,), -4.6, dtype=torch.float32,
                              device=dev),            # softplus ~ 0.01
        "norm": torch.zeros((di,), dtype=dtype, device=dev),
        "out_proj": dense_init(generator, di, d, dtype, device=device),
    }


def _split_zxbcdt(zxbcdt, cfg):
    di, N, G = cfg.d_inner, cfg.ssm_state, cfg.ssm_groups
    z = zxbcdt[..., :di]
    xBC = zxbcdt[..., di:2 * di + 2 * G * N]
    dt = zxbcdt[..., 2 * di + 2 * G * N:]
    return z, xBC, dt


def _causal_conv(xBC, w, b):
    """Depthwise causal conv over L. xBC (B,L,C); w (K,C)."""
    K, L = w.shape[0], xBC.shape[1]
    pad = F.pad(xBC, (0, 0, K - 1, 0))
    out = sum(pad[:, i:i + L, :] * w[i] for i in range(K))
    return F.silu(out + b)


def _segsum(a):
    """a (..., Q) -> (..., Q, Q) with L[l, s] = sum_{i in (s, l]} a_i
    (l >= s), −inf above the diagonal (its exp is 0, and so is the
    gradient there: `torch.where` passes none to the branch it drops)."""
    Q = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    dif = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=a.device))
    return torch.where(mask, dif, float("-inf"))


def ssd_chunked(x, a, Bm, Cm, cfg, init_state=None):
    """Chunked SSD scan.

    x  (B, L, H, P)   head inputs (already scaled by dt)
    a  (B, L, H)      log-decay per step (dt * A, negative)
    Bm, Cm (B, L, G, N)
    returns y (B, L, H, P), final_state (B, H, P, N)
    """
    Bsz, L, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    Hg = H // G
    Q = min(cfg.ssm_chunk, L)
    assert L % Q == 0, (L, Q)
    nc = L // Q

    xr = x.reshape(Bsz, nc, Q, G, Hg, P)
    ar = a.reshape(Bsz, nc, Q, H).float()
    Br = Bm.reshape(Bsz, nc, Q, G, N)
    Cr = Cm.reshape(Bsz, nc, Q, G, N)

    a_cum = torch.cumsum(ar, dim=2)                                 # (B,nc,Q,H)
    Lmat = torch.exp(_segsum(ar.permute(0, 1, 3, 2)))               # (B,nc,H,Q,Q)
    Lmat = Lmat.reshape(Bsz, nc, G, Hg, Q, Q)

    # intra-chunk (diagonal) term
    CB = torch.einsum("bclgn,bcsgn->bcgls", Cr.float(), Br.float())  # (B,nc,G,Q,Q)
    scores = CB[:, :, :, None] * Lmat                               # (B,nc,G,Hg,Q,Q)
    y_diag = torch.einsum("bcghls,bcsghp->bclghp", scores.to(x.dtype), xr)

    # chunk-final states
    decay_states = torch.exp(a_cum[:, :, -1:, :] - a_cum)           # (B,nc,Q,H)
    xd = xr * decay_states.reshape(Bsz, nc, Q, G, Hg)[..., None].to(x.dtype)
    states = torch.einsum("bcsgn,bcsghp->bcghpn", Br, xd)           # (B,nc,G,Hg,P,N)

    chunk_decay = torch.exp(a_cum[:, :, -1, :]).reshape(Bsz, nc, G, Hg)

    # the inter-chunk recurrence (JAX's lax.scan over the chunks)
    if init_state is None:
        prev = torch.zeros((Bsz, G, Hg, P, N), dtype=x.dtype, device=x.device)
    else:
        prev = init_state.reshape(Bsz, G, Hg, P, N)
    prevs = []
    for c in range(nc):
        prevs.append(prev)
        prev = (prev * chunk_decay[:, c, ..., None, None].to(prev.dtype)
                + states[:, c])
    final = prev
    prev_states = torch.stack(prevs, dim=1)                         # (B,nc,G,Hg,P,N)

    # inter-chunk (off-diagonal) term
    state_decay = torch.exp(a_cum).reshape(Bsz, nc, Q, G, Hg)
    y_off = torch.einsum("bclgn,bcghpn,bclgh->bclghp", Cr.float(),
                         prev_states.float(), state_decay).to(x.dtype)

    y = (y_diag + y_off).reshape(Bsz, L, H, P)
    return y, final.reshape(Bsz, H, P, N)


def mamba_apply(params, x, cfg):
    """Full-sequence Mamba2 block. x (B, L, d) -> (B, L, d). Placed, its
    heads run on each rank's local shards (`_mamba_placed`)."""
    if is_placed(x):
        return _mamba_placed(params, x, cfg)
    y = _mamba_core(x, x @ params["in_proj"], params, cfg,
                    lambda y, s: rms_norm(y, s, cfg.norm_eps))
    return y @ params["out_proj"]


def _mamba_core(x, zxbcdt, p, cfg, norm, H=None, G=None):
    """The block from the in-projection's output to the gated norm's, on
    plain tensors of `H` heads in `G` groups (default: all): `zxbcdt`
    holds z, x, B, C and dt of those heads (and groups) in JAX's order and
    `p` their parameters; `norm(y, scale)` is the gated RMSNorm over the
    whole d_inner."""
    B, L, _ = x.shape
    N, P = cfg.ssm_state, cfg.ssm_head_dim
    H = cfg.ssm_heads if H is None else H
    G = cfg.ssm_groups if G is None else G
    di = H * P
    z = zxbcdt[..., :di]
    xBC = zxbcdt[..., di:2 * di + 2 * G * N]
    dt = zxbcdt[..., 2 * di + 2 * G * N:]
    xBC = _causal_conv(xBC, p["conv_w"], p["conv_b"])
    xp = xBC[..., :di].reshape(B, L, H, P)
    Bm = xBC[..., di:di + G * N].reshape(B, L, G, N)
    Cm = xBC[..., di + G * N:].reshape(B, L, G, N)
    dt = F.softplus(dt.float() + p["dt_bias"])                       # (B,L,H)
    A = -torch.exp(p["A_log"])                                       # (H,)
    xp = shard(xp, ("batch", "seq", "ssm_heads", None))
    y, _ = ssd_chunked(xp * dt[..., None].to(x.dtype), dt * A, Bm, Cm, cfg)
    y = y + xp * p["D"][None, None, :, None].to(x.dtype)
    y = y.reshape(B, L, di)
    return norm(y * F.silu(z), p["norm"])


class _Heads:
    """The heads of the SSD a rank runs on a placed input, as JAX lays
    them out (``("batch", "seq", "ssm_heads", None)``, guarded): the mesh
    dims that split them, and this rank's heads [h0, h0 + h) in groups
    [g0, g0 + g). Where a rank's heads would neither cover whole groups nor
    lie in one group, the heads stay whole."""

    def __init__(self, x, cfg):
        from torch.distributed.tensor import Replicate, Shard
        from repro_torch.sharding.place import local_shape_offset, spec_dims
        mesh = x.device_mesh
        H, Gs = cfg.ssm_heads, cfg.ssm_groups
        spec = guarded_spec((x.shape[0], x.shape[1], H, cfg.ssm_head_dim),
                            ("batch", "seq", "ssm_heads", None), mesh)
        dims = spec_dims(mesh, spec[2])
        (h,), (h0,) = local_shape_offset((H,), mesh, [
            Shard(0) if i in dims else Replicate()
            for i in range(mesh.ndim)])
        per = H // Gs
        if dims and h % per and per % h:
            dims, h, h0 = (), H, 0
        self.dims, self.h, self.h0 = dims, h, h0
        self.g0, self.g = h0 // per, max(1, h // per)

    def columns(self, cfg, device):
        """The in-projection's columns of these heads (z, x, B, C, dt) and
        the conv's channels (x, B, C), as index tensors."""
        di, N, P, Gs = (cfg.d_inner, cfg.ssm_state, cfg.ssm_head_dim,
                        cfg.ssm_groups)

        def span(a, n):
            return torch.arange(a, a + n, device=device)
        xs = span(self.h0 * P, self.h * P)
        bc = torch.cat([span(di + self.g0 * N, self.g * N),
                        span(di + Gs * N + self.g0 * N, self.g * N)])
        conv = torch.cat([xs, bc])
        proj = torch.cat([xs, di + conv,
                          span(2 * di + 2 * Gs * N + self.h0, self.h)])
        return proj, conv

    @staticmethod
    def gather(params, grad_pl):
        """The block's parameters but the out-projection, gathered whole
        (`whole_local`, their gradients laid out by `grad_pl`)."""
        from repro_torch.sharding.place import whole_local
        return {n: whole_local(params[n], grad_pl)
                for n in ("in_proj", "conv_w", "conv_b", "A_log", "D",
                          "dt_bias", "norm")}

    def cut(self, p, cfg, device):
        """Whole parameters (`gather`) cut to these heads: the
        in-projection's and the conv's columns, A_log, D and dt_bias, the
        norm's channels."""
        if not self.dims:
            return p
        proj, conv = self.columns(cfg, device)
        P, heads = cfg.ssm_head_dim, slice(self.h0, self.h0 + self.h)
        out = {"in_proj": p["in_proj"][:, proj],
               "conv_w": p["conv_w"][:, conv], "conv_b": p["conv_b"][conv],
               "norm": p["norm"][self.h0 * P:(self.h0 + self.h) * P]}
        for n in ("A_log", "D", "dt_bias"):
            out[n] = p[n][heads]
        return out

    def norm(self, mesh, cfg):
        """The gated RMSNorm over the whole d_inner on this rank's channels:
        the sum of squares summed over the ranks that split the heads (in
        another order than one rank's mean), both passes; with whole heads,
        `rms_norm`."""
        if not self.dims:
            return lambda y, s: rms_norm(y, s, cfg.norm_eps)
        from repro_torch.sharding.place import all_reduce_grad

        def norm(y, scale):
            xf = y.float()
            ss = all_reduce_grad(torch.sum(torch.square(xf), dim=-1,
                                           keepdim=True), mesh, self.dims)
            out = xf * torch.rsqrt(ss / cfg.d_inner + cfg.norm_eps) \
                * (1.0 + scale.float())
            return out.to(y.dtype)
        return norm

    def out_placements(self, xw, last):
        """The placements of the output before the out-projection, whose
        dim `last` is d_inner: the batch's split (`xw`'s), d_inner split
        with the heads."""
        from torch.distributed.tensor import Shard
        return [Shard(last) if i in self.dims else p
                for i, p in enumerate(xw.placements)]


def _grad_placements(xw, heads):
    """The gradient layout of a parameter gathered whole and read by this
    rank's batch and heads: partial over both splits."""
    from torch.distributed.tensor import Partial, Replicate
    return [Partial() if p.is_shard(0) or i in heads.dims else Replicate()
            for i, p in enumerate(xw.placements)]


def _mamba_placed(params, x, cfg):
    """The block on placed tensors, on each rank's local shards: its batch
    as it is split, its heads as JAX's ``shard(xp, ("batch", "seq",
    "ssm_heads", None))`` splits them (`_Heads`). The in-projection (whose
    column split over ``model`` cuts across the z | x | B | C | dt
    sections), the conv and the per-head vectors are gathered whole and cut
    to the rank's heads — B and C whole —; the chunked scan runs on plain
    tensors; the gated norm sums its squares over the heads' split; the
    out-projection is row-parallel over the heads (`row_parallel`).
    Gradients: every gathered parameter's partial over the batch's and the
    heads' splits, the input's partial over the heads' split."""
    from torch.distributed.tensor import Partial
    from repro_torch.sharding.place import batch_split_only, wrap_local
    mesh = x.device_mesh
    xw = batch_split_only(x)
    heads = _Heads(xw, cfg)
    p = heads.cut(heads.gather(params, _grad_placements(xw, heads)), cfg,
                  x.device)
    xl = xw.to_local(grad_placements=[
        Partial() if i in heads.dims else q
        for i, q in enumerate(xw.placements)])
    y = _mamba_core(xl, xl @ p["in_proj"], p, cfg, heads.norm(mesh, cfg),
                    H=heads.h, G=heads.g if heads.dims else None)
    y = wrap_local(y, mesh, heads.out_placements(xw, 2),
                   tuple(x.shape[:2]) + (cfg.d_inner,))
    out = row_parallel(y, params["out_proj"])
    return out if tuple(out.placements) == tuple(x.placements) else \
        out.redistribute(mesh, x.placements)


def mamba_init_cache(cfg, batch, dtype, device=None):
    di, N, G, H, P, K = (cfg.d_inner, cfg.ssm_state, cfg.ssm_groups,
                         cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_conv)
    conv_ch = di + 2 * G * N
    return {
        "conv": torch.zeros((batch, K - 1, conv_ch), dtype=dtype,
                            device=device),
        "state": torch.zeros((batch, H, P, N), dtype=torch.float32,
                             device=device),
    }


def mamba_decode(params, x, cache, cfg):
    """Single-step recurrence. x (B, 1, d) -> (y (B,1,d), a new cache); the
    cache given is not written. Placed, its heads run on each rank's local
    shards (`_mamba_decode_placed`)."""
    if is_placed(x):
        return _mamba_decode_placed(params, x, cache, cfg)
    z, xBC, dt = _split_zxbcdt((x @ params["in_proj"])[:, 0], cfg)  # (B, *)
    conv_buf = torch.cat([cache["conv"], xBC[:, None]], dim=1)       # (B,K,C)
    y, state = _decode_core(x, z, conv_buf, dt, cache["state"], params,
                            cfg, lambda y, s: rms_norm(y, s, cfg.norm_eps))
    y = (y @ params["out_proj"])[:, None]
    return y, {"conv": conv_buf[:, 1:], "state": state}


def _decode_core(x, z, conv_buf, dt, state, p, cfg, norm, H=None, G=None):
    """One step from the conv window (B, K, C) to the gated norm's output,
    on plain tensors of `H` heads in `G` groups (default: all): `z`, `dt`,
    `conv_buf` and `state` (B, H, P, N) hold those heads (and groups), `p`
    their parameters -> (y (B, H·P), the new state)."""
    B = x.shape[0]
    N, P = cfg.ssm_state, cfg.ssm_head_dim
    H = cfg.ssm_heads if H is None else H
    G = cfg.ssm_groups if G is None else G
    di = H * P
    xBC = F.silu(torch.einsum("bkc,kc->bc", conv_buf, p["conv_w"])
                 + p["conv_b"])
    xp = xBC[..., :di].reshape(B, H, P)
    Bm = xBC[..., di:di + G * N].reshape(B, G, N)
    Cm = xBC[..., di + G * N:].reshape(B, G, N)
    dt = F.softplus(dt.float() + p["dt_bias"])                       # (B,H)
    A = -torch.exp(p["A_log"])
    decay = torch.exp(dt * A)                                        # (B,H)
    Hg = H // G
    xdt = (xp * dt[..., None].to(xp.dtype)).reshape(B, G, Hg, P)
    upd = torch.einsum("bgn,bghp->bghpn", Bm, xdt).reshape(B, H, P, N)
    state = state * decay[..., None, None] + upd.float()
    y = torch.einsum("bghpn,bgn->bghp", state.reshape(B, G, Hg, P, N),
                     Cm.float()).reshape(B, H, P)
    y = y.to(x.dtype) + xp * p["D"][None, :, None].to(x.dtype)
    y = y.reshape(B, di)
    return norm(y * F.silu(z), p["norm"]), state


def _mamba_decode_placed(params, x, cache, cfg):
    """One step on placed tensors, on each rank's local shards: the
    in-projection gathered whole and run whole on the rank's batch (B
    tokens), the conv window read whole from the cache's channel split,
    the step run on the rank's heads (`_Heads`) with the state's heads as
    the cache splits them, the gated norm's squares summed over the heads'
    split, the out-projection row-parallel. The new cache comes back laid
    out as the given one (`infer_decode_cache_shardings`: the state's
    heads and the conv's channels over ``model``)."""
    from torch.distributed.tensor import Shard
    from repro_torch.sharding.place import (batch_split_only,
                                            distribute_tensor_local,
                                            wrap_local)
    mesh, nd = x.device_mesh, x.device_mesh.ndim
    B, di = x.shape[0], cfg.d_inner
    xw = batch_split_only(x)
    heads = _Heads(xw, cfg)
    whole = heads.gather(params, _grad_placements(xw, heads))
    p = heads.cut(whole, cfg, x.device)
    row = list(xw.placements)
    st_pl = [Shard(1) if i in heads.dims else row[i] for i in range(nd)]

    def local(t, pl):
        if not is_placed(t):
            return distribute_tensor_local(t, mesh, pl).to_local()
        return (t if tuple(t.placements) == tuple(pl)
                else t.redistribute(mesh, pl)).to_local()

    zxbcdt = (xw.to_local() @ whole["in_proj"])[:, 0]
    z, xBC, dt = _split_zxbcdt(zxbcdt, cfg)
    conv_buf = torch.cat([local(cache["conv"], row), xBC[:, None]], dim=1)
    new_conv = conv_buf[:, 1:]
    state = local(cache["state"], st_pl)
    if heads.dims:
        conv = heads.columns(cfg, x.device)[1]
        P, h0, h = cfg.ssm_head_dim, heads.h0, heads.h
        z, dt = z[:, h0 * P:(h0 + h) * P], dt[:, h0:h0 + h]
        conv_buf = conv_buf[..., conv]
    y, state = _decode_core(xw.to_local(), z, conv_buf, dt, state, p, cfg,
                            heads.norm(mesh, cfg), H=heads.h,
                            G=heads.g if heads.dims else None)
    y = wrap_local(y, mesh, heads.out_placements(xw, 1), (B, di))
    y = row_parallel(y, params["out_proj"])[:, None]
    if tuple(y.placements) != tuple(x.placements):
        y = y.redistribute(mesh, x.placements)

    def back(t, pl, old):
        t = wrap_local(t, mesh, pl, old.shape)
        if not is_placed(old):
            return t.full_tensor()
        return t if tuple(t.placements) == tuple(old.placements) else \
            t.redistribute(mesh, old.placements)
    return y, {"conv": back(new_conv, row, cache["conv"]),
               "state": back(state, st_pl, cache["state"])}
