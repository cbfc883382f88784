"""The port's chunked (flash-style) attention and decode attention against
the JAX package's (`repro.models.attention`) on the same inputs, with
tests/test_attention.py's parametrisation: causal, sliding window and
softcap, lengths that the blocks do and do not divide, a separate value
dimension and cross-attention lengths. Outputs within 1e-5 of JAX's
(relative to the larger of 1 and max|JAX|)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.models import attention as jattn  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402

torch.set_num_threads(1)


def normal(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def close(t, j, tol=1e-5):
    j = np.asarray(j)
    assert t.shape == j.shape
    assert np.max(np.abs(t.numpy() - j)) <= tol * max(1.0, np.abs(j).max())


@pytest.mark.parametrize("causal,window,cap", [
    (True, 0, 0.0), (True, 7, 0.0), (False, 0, 0.0),
    (True, 0, 50.0), (True, 13, 30.0),
])
@pytest.mark.parametrize("L,qb,kb", [(50, 16, 8), (64, 64, 64), (33, 8, 16)])
def test_chunked_matches_jax(causal, window, cap, L, qb, kb):
    B, H, Hkv, D = 2, 4, 2, 16
    q, k, v = (normal(s, (B, L, h, D)) for s, h in ((0, H), (1, Hkv),
                                                      (2, Hkv)))
    kw = dict(causal=causal, window=window, softcap_val=cap, q_block=qb,
              kv_block=kb)
    out_j = jattn.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), **kw)
    out_t = tattn.chunked_attention(torch.as_tensor(q), torch.as_tensor(k),
                                    torch.as_tensor(v), **kw)
    close(out_t, out_j)


def test_separate_value_dim():
    B, L, H, D, Dv = 2, 24, 4, 16, 8
    q, k, v = normal(3, (B, L, H, D)), normal(4, (B, L, H, D)), \
        normal(5, (B, L, H, Dv))
    out_j = jattn.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), q_block=8, kv_block=8)
    out_t = tattn.chunked_attention(torch.as_tensor(q), torch.as_tensor(k),
                                    torch.as_tensor(v), q_block=8,
                                    kv_block=8)
    assert out_t.shape == (B, L, H, Dv)
    close(out_t, out_j)


@pytest.mark.parametrize("cap", [0.0, 30.0])
def test_decode_attention_matches_jax(cap):
    B, S, H, Hkv, D = 2, 20, 4, 2, 16
    q, k, v = normal(6, (B, H, D)), normal(7, (B, S, Hkv, D)), \
        normal(8, (B, S, Hkv, D))
    valid = np.broadcast_to(np.arange(S)[None, :] < 13, (B, S))
    out_j = jattn.decode_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), jnp.asarray(valid),
                                   softcap_val=cap)
    out_t = tattn.decode_attention(torch.as_tensor(q), torch.as_tensor(k),
                                   torch.as_tensor(v),
                                   torch.as_tensor(valid.copy()),
                                   softcap_val=cap)
    close(out_t, out_j)


def test_cross_attention_lengths_differ():
    B, Lq, Lk, H, D = 2, 10, 31, 4, 16
    q, k, v = normal(9, (B, Lq, H, D)), normal(10, (B, Lk, H, D)), \
        normal(11, (B, Lk, H, D))
    kw = dict(causal=False, q_block=4, kv_block=8)
    out_j = jattn.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), **kw)
    out_t = tattn.chunked_attention(torch.as_tensor(q), torch.as_tensor(k),
                                    torch.as_tensor(v), **kw)
    assert out_t.shape == (B, Lq, H, D)
    close(out_t, out_j)


def test_memory_stays_one_tile():
    """Only one (q block, kv block) score tile is formed at a time: at L =
    4096 with blocks of 512, no intermediate holds L² scores."""
    B, L, H, D = 1, 4096, 2, 8
    q = torch.randn(B, L, H, D, generator=torch.Generator().manual_seed(0))
    biggest = []

    class Watch(torch.utils._python_dispatch.TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if isinstance(out, torch.Tensor):
                biggest.append(out.numel())
            return out
    with Watch():
        tattn.chunked_attention(q, q, q, q_block=512, kv_block=512)
    assert max(biggest) <= B * H * 512 * 512 + B * L * H * D
