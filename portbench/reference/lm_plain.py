"""Plain PyTorch reference of the decoder language models the benchmark's
configurations name: a loss and its gradient, written from the layer
equations with no kernel, cache, chunking or batching over lanes.

It imports nothing of the program. Parameters are a flat dict from a path
(``"stages.0.0.attn.wq"``) to a tensor, the layout the harness makes the
weights in: ``x @ w`` with ``w`` of shape (in, out), a stage's leaves
leading with its repeats, a shared attention block at ``shared_block``.

Layers (the repository's models, as the configuration file states them):

* embedding lookup, times sqrt(d_model) where the file's
  ``embed_scale`` says ``"sqrt_d_model"``; logits against the same table
  where ``tie_embeddings`` is true, else against an output table of
  their own (``unembed``, (d_model, vocab));
* RMSNorm ``x / sqrt(mean(x^2) + eps) * (1 + scale)`` in f32;
* GQA attention with rotate-half RoPE, causal, a window for the windowed
  kinds, softmax in f32 over the whole L x L score matrix; with
  ``qk_norm``, an RMSNorm over each head of q and of k before RoPE;
* SwiGLU MLP ``(silu(x wg) * (x wu)) wo``;
* Mamba-2 (SSD) with one group: in-projection to z, x, B, C, dt; a
  depthwise causal conv and SiLU over x, B, C; dt = softplus(dt + bias);
  the state-space output in its quadratic (attention-like) form over the
  whole sequence, ``y_l = sum_{s<=l} (C_l . B_s) exp(sum_{s<r<=l} dt_r A)
  dt_s x_s + D x_l``; a gated RMSNorm ``norm(y * silu(z))`` and the
  out-projection;
* the repository's shared attention block (``shared_attn``): the same
  attention + MLP block at every use, with one set of parameters, over
  the hidden state alone (Zamba2's own block also takes the original
  embedding, concatenated, and adds adapters: not built here).

`Precision` sets the matrix products: "float32" (TF32 off) or "tf32"
(TF32 on the card; on the CPU its inputs rounded to TF32's 10-bit
mantissa), the control one precision below what the configurations state.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

_MAMBA, _SHARED = "mamba", "shared_attn"
_WINDOWED = ("attn_local", "shared_attn")
_SUPPORTED = ("attn", "attn_local", "mamba", "shared_attn")


def _tf32_round(x):
    """x rounded to TF32 (10 explicit mantissa bits), nearest even; the
    gradient passes through unrounded."""
    bits = x.detach().float().contiguous().view(torch.int32)
    bias = ((bits >> 13) & 1) + 0x0FFF
    rounded = ((bits + bias) & ~0x1FFF).view(torch.float32)
    return x + (rounded - x).detach()


class Precision:
    """The matrix products' precision: "float32" or "tf32"."""

    def __init__(self, name: str):
        if name not in ("float32", "tf32"):
            raise ValueError(f"precision {name!r}: float32 or tf32")
        self.name = name

    def __enter__(self):
        self._saved = (torch.backends.cuda.matmul.allow_tf32,
                       torch.backends.cudnn.allow_tf32)
        on = self.name == "tf32"
        torch.backends.cuda.matmul.allow_tf32 = on
        torch.backends.cudnn.allow_tf32 = on
        return self

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self._saved

    def mm(self, a, b):
        if self.name == "tf32" and a.device.type == "cpu":
            return _tf32_round(a) @ _tf32_round(b)
        return a @ b

    def einsum(self, eq, *xs):
        if self.name == "tf32" and xs[0].device.type == "cpu":
            xs = [_tf32_round(x) for x in xs]
        return torch.einsum(eq, *xs)


def _rms(x, scale, eps):
    x = x.float()
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) \
        * (1.0 + scale.float())


def _rope(x, positions, theta):
    """Rotate-half RoPE on x (B, L, H, D) at integer positions (L,)."""
    half = x.shape[-1] // 2
    inv = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                        device=x.device) / half))
    ang = positions.float()[:, None] * inv[None]
    c, s = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    a, b = x[..., :half], x[..., half:]
    return torch.cat([a * c - b * s, b * c + a * s], dim=-1)


class Model:
    """The loss of one configuration (a dict of the configuration file's
    model keys) over plain parameters."""

    def __init__(self, cfg: Dict, precision: str = "float32"):
        for key in ("use_mla", "num_experts", "logit_softcap",
                    "attn_softcap", "is_encoder_decoder"):
            if cfg.get(key):
                raise NotImplementedError(f"{key} has no plain reference "
                                          "here")
        self.cfg = cfg
        self.p = Precision(precision)
        self.stages = [(tuple(pattern), int(reps))
                       for pattern, reps in cfg["stages"]]
        for pattern, _ in self.stages:
            for kind in pattern:
                if kind not in _SUPPORTED:
                    raise NotImplementedError(f"layer kind {kind!r}")
        self.eps = float(cfg.get("norm_eps", 1e-6))
        self.hd = int(cfg.get("head_dim")
                      or cfg["d_model"] // max(cfg["num_heads"], 1))
        self.tied = bool(cfg.get("tie_embeddings", True))
        scale = cfg.get("embed_scale", "none")
        if scale not in ("none", "sqrt_d_model"):
            raise ValueError(f"embed_scale {scale!r}: none or sqrt_d_model")
        self.embed_mul = math.sqrt(cfg["d_model"]) if scale != "none" else 1.0

    # -- the parameters the configuration has: path -> shape -------------
    def shapes(self) -> Dict[str, Tuple[int, ...]]:
        c, hd = self.cfg, self.hd
        d, V = c["d_model"], c["vocab_size"]
        out = {"embed.embedding": (V, d), "final_norm": (d,)}
        if not self.tied:
            out["unembed"] = (d, V)

        def attn_block(pre, lead):
            qk = ({pre + "attn.q_norm": lead + (hd,),
                   pre + "attn.k_norm": lead + (hd,)}
                  if c.get("qk_norm") else {})
            return {**qk, pre + "ln1": lead + (d,), pre + "ln2": lead + (d,),
                    pre + "attn.wq": lead + (d, c["num_heads"] * hd),
                    pre + "attn.wk": lead + (d, c["num_kv_heads"] * hd),
                    pre + "attn.wv": lead + (d, c["num_kv_heads"] * hd),
                    pre + "attn.wo": lead + (c["num_heads"] * hd, d),
                    pre + "ffn.wi_gate": lead + (d, c["d_ff"]),
                    pre + "ffn.wi_up": lead + (d, c["d_ff"]),
                    pre + "ffn.wo": lead + (c["d_ff"], d)}

        def mamba_block(pre, lead):
            di, N, P = self._ssm()
            H, G, K = di // P, int(c.get("ssm_groups", 1)), c["ssm_conv"]
            ch = di + 2 * G * N
            m = pre + "mamba."
            return {pre + "ln1": lead + (d,),
                    m + "in_proj": lead + (d, 2 * di + 2 * G * N + H),
                    m + "conv_w": lead + (K, ch), m + "conv_b": lead + (ch,),
                    m + "A_log": lead + (H,), m + "D": lead + (H,),
                    m + "dt_bias": lead + (H,), m + "norm": lead + (di,),
                    m + "out_proj": lead + (di, d)}

        shared = False
        for si, (pattern, reps) in enumerate(self.stages):
            for ki, kind in enumerate(pattern):
                pre = f"stages.{si}.{ki}."
                if kind == _MAMBA:
                    out.update(mamba_block(pre, (reps,)))
                elif kind == _SHARED:
                    shared = True
                else:
                    out.update(attn_block(pre, (reps,)))
        if shared:
            out.update(attn_block("shared_block.", ()))
        return out

    def _ssm(self):
        c = self.cfg
        return (int(c.get("ssm_expand", 2)) * c["d_model"], c["ssm_state"],
                c["ssm_head_dim"])

    # -- layers ---------------------------------------------------------
    def _attention(self, P, pre, x, kind, positions):
        c, hd, p = self.cfg, self.hd, self.p
        B, L, _ = x.shape
        H, Hkv = c["num_heads"], c["num_kv_heads"]
        q = p.mm(x, P[pre + "attn.wq"]).reshape(B, L, H, hd)
        k = p.mm(x, P[pre + "attn.wk"]).reshape(B, L, Hkv, hd)
        v = p.mm(x, P[pre + "attn.wv"]).reshape(B, L, Hkv, hd)
        if c.get("qk_norm"):
            q = _rms(q, P[pre + "attn.q_norm"], self.eps)
            k = _rms(k, P[pre + "attn.k_norm"], self.eps)
        theta = float(c.get("rope_theta", 1e4))
        q, k = _rope(q, positions, theta), _rope(k, positions, theta)
        k = k.repeat_interleave(H // Hkv, dim=2)
        v = v.repeat_interleave(H // Hkv, dim=2)
        s = p.einsum("blhd,bshd->bhls", q, k).float() / math.sqrt(hd)
        allowed = positions[None, :] <= positions[:, None]
        window = int(c.get("window_size", 0)) if kind in _WINDOWED else 0
        if window:
            allowed = allowed & (positions[None, :]
                                 > positions[:, None] - window)
        s = s.masked_fill(~allowed, float("-inf"))
        o = p.einsum("bhls,bshd->blhd", torch.softmax(s, -1), v)
        return p.mm(o.reshape(B, L, H * hd), P[pre + "attn.wo"])

    def _attn_block(self, P, pre, x, kind, positions):
        h = _rms(x, P[pre + "ln1"], self.eps)
        x = x + self._attention(P, pre, h, kind, positions)
        h = _rms(x, P[pre + "ln2"], self.eps)
        p = self.p
        g = F.silu(p.mm(h, P[pre + "ffn.wi_gate"])) \
            * p.mm(h, P[pre + "ffn.wi_up"])
        return x + p.mm(g, P[pre + "ffn.wo"])

    def _mamba(self, P, pre, x):
        c, p = self.cfg, self.p
        di, N, Pd = self._ssm()
        H, G = di // Pd, int(c.get("ssm_groups", 1))
        if G != 1:
            raise NotImplementedError("ssm_groups > 1")
        B, L, _ = x.shape
        m = pre + "mamba."
        h = _rms(x, P[pre + "ln1"], self.eps)
        zxbcdt = p.mm(h, P[m + "in_proj"])
        z, xbc, dt = (zxbcdt[..., :di], zxbcdt[..., di:2 * di + 2 * N],
                      zxbcdt[..., 2 * di + 2 * N:])
        K = P[m + "conv_w"].shape[0]
        padded = F.pad(xbc, (0, 0, K - 1, 0))
        conv = torch.zeros_like(xbc)
        for i in range(K):
            conv = conv + padded[:, i:i + L] * P[m + "conv_w"][i]
        xbc = F.silu(conv + P[m + "conv_b"])
        xs = xbc[..., :di].reshape(B, L, H, Pd)
        Bm, Cm = xbc[..., di:di + N], xbc[..., di + N:]
        dt = F.softplus(dt.float() + P[m + "dt_bias"])           # (B, L, H)
        a = dt * -torch.exp(P[m + "A_log"])                       # (B, L, H)
        cum = torch.cumsum(a, dim=1)                              # (B, L, H)
        # decay[b, h, l, s] = exp(sum_{s<r<=l} a_r) for s <= l, else 0
        diff = cum.permute(0, 2, 1)[..., :, None] \
            - cum.permute(0, 2, 1)[..., None, :]
        causal = torch.ones((L, L), dtype=torch.bool,
                            device=x.device).tril()
        decay = torch.exp(diff.masked_fill(~causal, float("-inf")))
        cb = p.einsum("bln,bsn->bls", Cm, Bm)                     # (B, L, L)
        scores = cb[:, None] * decay                              # (B,H,L,L)
        y = p.einsum("bhls,bshp->blhp", scores, xs * dt[..., None])
        y = y + xs * P[m + "D"][:, None]
        y = y.reshape(B, L, di) * F.silu(z)
        return x + p.mm(_rms(y, P[m + "norm"], self.eps), P[m + "out_proj"])

    # -- the loss -------------------------------------------------------
    def loss(self, P: Dict[str, torch.Tensor], tokens, targets):
        """Mean next-token cross-entropy of tokens (B, L) against targets
        (B, L), f32."""
        emb = P["embed.embedding"]
        x = emb[tokens.long()] * self.embed_mul
        positions = torch.arange(tokens.shape[1], device=tokens.device)
        for si, (pattern, reps) in enumerate(self.stages):
            for r in range(reps):
                for ki, kind in enumerate(pattern):
                    pre = f"stages.{si}.{ki}."
                    if kind == _MAMBA:
                        x = self._mamba(_unit(P, pre, r), pre, x)
                    elif kind == _SHARED:
                        x = self._attn_block(P, "shared_block.", x, kind,
                                             positions)
                    else:
                        x = self._attn_block(_unit(P, pre, r), pre, x, kind,
                                             positions)
        x = _rms(x, P["final_norm"], self.eps)
        logits = self.p.mm(x, emb.T if self.tied else P["unembed"]).float()
        return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                               targets.reshape(-1).long())

    def grad(self, P: Dict[str, torch.Tensor], names: Sequence[str], tokens,
             targets) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """(loss, the gradient of each parameter in `names`)."""
        with self.p, torch.enable_grad():
            leaves = {k: P[k].detach().requires_grad_(True) for k in names}
            loss = self.loss(leaves, tokens, targets)
            grads = torch.autograd.grad(loss, [leaves[k] for k in names])
        return loss.detach(), list(grads)


def _unit(P, pre, r):
    """The stage's parameters of repeat `r` under their own paths."""
    return {k: (v[r] if k.startswith(pre) else v) for k, v in P.items()}
