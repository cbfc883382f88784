"""The port's checkpoints (`repro_torch.checkpoint`) against the JAX
package's `repro.checkpoint`, on the CPU:

  * tests/test_data_optim_ckpt.py's round trip and rotation, and
    tests/test_faults.py's crash-safety cases (a truncated newest
    checkpoint falls back, a flipped byte fails the checksum, all bad gives
    the template back, a transient IO error retries, a failed save leaves
    nothing, a legacy file without a sidecar restores, rotation takes the
    sidecars), all on the port;
  * one file format: a tree of f32, int8 and int32 leaves that either
    package saves, the other restores bit for bit, and a train state with a
    `FlatCache` keys its leaves as JAX's (``.params``, ``.data``);
  * bfloat16 leaves round-trip bit for bit (stored as their exact f32), and
    either package restores the other's bfloat16 leaves bit for bit;
  * a tree-layout chunked run (the reduced yi LM task, ACED, the fault
    guards and resync on) saved and restored mid-run through
    `save_train_checkpoint` / `restore_train_checkpoint` equals the
    straight run bit for bit, guard counters included, and its counters
    equal the one-shot runner's.
"""
import json
import os
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import restore_checkpoint as jax_restore  # noqa: E402
from repro.checkpoint import save_checkpoint as jax_save  # noqa: E402
from repro.core.cache import FlatCache as JFlatCache  # noqa: E402
from repro.core.distributed import AFLTrainState as JState  # noqa: E402
import repro_torch.checkpoint.checkpoint as ck  # noqa: E402
from repro_torch.checkpoint import (latest_step, restore_checkpoint,  # noqa: E402
                                    restore_train_checkpoint,
                                    save_checkpoint, save_train_checkpoint,
                                    verify_checkpoint)
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core.aggregators import ACED  # noqa: E402
from repro_torch.core.cache import FlatCache  # noqa: E402
from repro_torch.core.distributed import AFLTrainState  # noqa: E402
from repro_torch.core.fl_tasks import make_lm_task  # noqa: E402
from repro_torch.core.scan_engine import (build_payload_noise,  # noqa: E402
                                          default_n_events)
from repro_torch.core.scan_staleness import (  # noqa: E402
    build_fault_schedule, build_staleness_randomness,
    make_chunked_staleness_runner, make_staleness_runner)

torch.set_num_threads(1)


def _toy_carry(x=0.0):
    return {"w": torch.arange(8, dtype=torch.float32) + x,
            "t": torch.tensor(int(x), dtype=torch.int32)}


def _ckpt_path(tmp_path, step):
    return str(tmp_path / f"afl_{step:08d}.npz")


def _leaves(tree):
    return [leaf for _, leaf in ck._paths(tree)]


def _same(a, b):
    a, b = (x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
            for x in (a, b))
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(
        a.reshape(-1).view(np.uint8), b.reshape(-1).view(np.uint8))


def test_checkpoint_roundtrip_and_rotation():
    tree = {"params": {"w": torch.arange(6, dtype=torch.float32
                                         ).reshape(2, 3)},
            "afl": {"cache": {"q": torch.ones((4, 5), dtype=torch.int8),
                              "scale": torch.ones((4,))}},
            "step": torch.tensor(7, dtype=torch.int32)}
    with tempfile.TemporaryDirectory() as d:
        for s in (1, 2, 3, 4):
            save_checkpoint(d, s, tree, keep=2)
        assert latest_step(d) == 4
        npz = [f for f in os.listdir(d) if f.endswith(".npz")]
        assert len(npz) == 2                        # rotation keeps 2
        target = ck._rebuild(tree, lambda _, x: torch.zeros_like(x))
        back = restore_checkpoint(d, 4, target)
        for a, b in zip(_leaves(back), _leaves(tree)):
            assert _same(a, b)
        with open(os.path.join(d, "ckpt_structure.json")) as f:
            assert json.load(f) == {
                "['afl']/['cache']/['q']": {"shape": [4, 5], "dtype": "int8"},
                "['afl']/['cache']/['scale']": {"shape": [4],
                                                "dtype": "float32"},
                "['params']/['w']": {"shape": [2, 3], "dtype": "float32"},
                "['step']": {"shape": [], "dtype": "int32"}}


def test_truncated_checkpoint_falls_back(tmp_path):
    save_train_checkpoint(tmp_path, 10, _toy_carry(1.0))
    save_train_checkpoint(tmp_path, 20, _toy_carry(2.0))
    with open(_ckpt_path(tmp_path, 20), "r+b") as f:
        f.truncate(f.seek(0, 2) // 2)
    with pytest.warns(RuntimeWarning, match="corrupt"):
        carry, step = restore_train_checkpoint(tmp_path, _toy_carry())
    assert step == 10
    assert _same(carry["w"], _toy_carry(1.0)["w"])
    assert _same(carry["t"], _toy_carry(1.0)["t"])


def test_checksum_flip_detected(tmp_path):
    save_train_checkpoint(tmp_path, 5, _toy_carry(1.0))
    save_train_checkpoint(tmp_path, 6, _toy_carry(2.0))
    p = _ckpt_path(tmp_path, 6)
    assert verify_checkpoint(p)
    with open(p, "r+b") as f:
        f.seek(-1, 2)
        last = f.read(1)
        f.seek(-1, 2)
        f.write(bytes([last[0] ^ 0xFF]))
    assert not verify_checkpoint(p)
    assert latest_step(tmp_path, prefix="afl") == 6
    assert latest_step(tmp_path, prefix="afl", verified=True) == 5


def test_all_checkpoints_bad_returns_template(tmp_path):
    save_train_checkpoint(tmp_path, 3, _toy_carry(1.0))
    with open(_ckpt_path(tmp_path, 3), "wb") as f:
        f.write(b"not an npz")
    template = _toy_carry()
    with pytest.warns(RuntimeWarning):
        carry, step = restore_train_checkpoint(tmp_path, template)
    assert step == 0
    assert carry is template


def test_unrestorable_checkpoint_is_skipped(tmp_path):
    """A checkpoint that verifies but does not fit the template (another
    shape) is skipped with a warning, and the one before it restores."""
    save_train_checkpoint(tmp_path, 1, _toy_carry(1.0))
    save_train_checkpoint(tmp_path, 2, {"w": torch.zeros(9),
                                         "t": torch.tensor(0, dtype=torch.int32)})
    with pytest.warns(RuntimeWarning, match="unrestorable"):
        carry, step = restore_train_checkpoint(tmp_path, _toy_carry())
    assert step == 1 and _same(carry["w"], _toy_carry(1.0)["w"])


def test_legacy_checkpoint_without_sidecar_restores(tmp_path):
    save_train_checkpoint(tmp_path, 7, _toy_carry(3.0))
    os.remove(_ckpt_path(tmp_path, 7) + ".sha256")
    assert verify_checkpoint(_ckpt_path(tmp_path, 7))
    carry, step = restore_train_checkpoint(tmp_path, _toy_carry())
    assert step == 7
    assert _same(carry["w"], _toy_carry(3.0)["w"])


def test_save_retries_transient_io(tmp_path, monkeypatch):
    real_replace = ck.os.replace
    fails = {"left": 2}

    def flaky(src, dst):
        if fails["left"] > 0:
            fails["left"] -= 1
            raise OSError("transient")
        return real_replace(src, dst)

    monkeypatch.setattr(ck.os, "replace", flaky)
    path = ck.save_checkpoint(str(tmp_path), 1, _toy_carry(), prefix="afl",
                              backoff=0.001)
    assert fails["left"] == 0
    assert ck.verify_checkpoint(path)


def test_failed_save_leaves_no_partial(tmp_path, monkeypatch):
    def broken(src, dst):
        raise OSError("disk full")

    monkeypatch.setattr(ck.os, "replace", broken)
    with pytest.raises(OSError):
        ck.save_checkpoint(str(tmp_path), 2, _toy_carry(), prefix="afl",
                           retries=2, backoff=0.001)
    leftover = [p for p in tmp_path.iterdir()
                if p.name.endswith((".npz", ".tmp"))]
    assert leftover == []


def test_rotation_removes_sidecars(tmp_path):
    for step in range(5):
        save_checkpoint(str(tmp_path), step, _toy_carry(float(step)),
                        prefix="ck", keep=2)
    files = sorted(os.listdir(tmp_path))
    npz = [f for f in files if f.endswith(".npz")]
    sidecars = [f for f in files if f.endswith(".sha256")]
    assert npz == ["ck_00000003.npz", "ck_00000004.npz"]
    assert sidecars == ["ck_00000003.npz.sha256", "ck_00000004.npz.sha256"]


# ---------------------------------------------------------------------------
# one file format for both packages
# ---------------------------------------------------------------------------

def _mixed_tree(rng):
    """A params tree (numpy) of f32, int8 and int32 leaves, with a list."""
    return {"blocks": [{"w": rng.normal(size=(3, 4)).astype(np.float32),
                        "q": rng.integers(-127, 128, size=(2, 5)
                                          ).astype(np.int8)},
                       {"w": np.array([np.inf, -0.0, 1e-40, np.nan],
                                      np.float32),
                        "q": np.zeros((1,), np.int8)}],
            "count": np.array(7, np.int32),
            "ids": rng.integers(-2 ** 31, 2 ** 31 - 1, size=(6,)
                                ).astype(np.int32)}


def _as_torch(tree):
    return ck._rebuild(tree, lambda _, x: torch.as_tensor(x.copy()))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoints_interchange_bit_for_bit(tmp_path, writer):
    tree = _mixed_tree(np.random.default_rng(0))
    if writer == "jax":
        jax_save(str(tmp_path), 3, jax.tree.map(jnp.asarray, tree))
        back = restore_checkpoint(str(tmp_path), 3, ck._rebuild(
            _as_torch(tree), lambda _, x: torch.zeros_like(x)))
        assert all(isinstance(x, torch.Tensor) for x in _leaves(back))
    else:
        save_checkpoint(str(tmp_path), 3, _as_torch(tree))
        back = jax_restore(str(tmp_path), 3, jax.tree.map(
            lambda x: jnp.zeros_like(jnp.asarray(x)), tree))
    for a, b in zip(_leaves(back), _leaves(tree)):
        assert _same(a, b)


def test_train_state_keys_are_jaxs(tmp_path):
    """A train state (NamedTuple) over a flat rule state (`FlatCache`) gets
    the keys JAX gives its own: ``.params``, ``.afl/['cache']/.data``."""
    rng = np.random.default_rng(1)
    w, data, scale = (rng.normal(size=s).astype(np.float32)
                      for s in ((4,), (3, 4), (3,)))

    def state(cls, cache_cls, arr):
        return cls(params={"w": arr(w)}, opt_state={"step": arr(
            np.int32(2))}, afl={"cache": cache_cls(arr(data), arr(scale)),
                                "u": arr(w)}, step=arr(np.int32(5)))

    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jax_save(str(jdir), 1, state(JState, JFlatCache, jnp.asarray))
    save_checkpoint(str(tdir), 1, state(AFLTrainState, FlatCache,
                                        lambda a: torch.as_tensor(a)))
    with np.load(jdir / "ckpt_00000001.npz") as j, \
            np.load(tdir / "ckpt_00000001.npz") as t:
        assert sorted(j.files) == sorted(t.files)
        assert ".afl/['cache']/.data" in t.files
        for k in j.files:
            assert _same(j[k], t[k])
    template = state(AFLTrainState, FlatCache,
                     lambda a: torch.zeros(np.shape(a), dtype=torch.as_tensor(
                         a).dtype))
    back = restore_checkpoint(str(jdir), 1, template)
    assert isinstance(back, AFLTrainState)
    assert isinstance(back.afl["cache"], FlatCache)
    assert _same(back.afl["cache"].data, torch.as_tensor(data))


def test_bfloat16_leaves_round_trip_bit_for_bit(tmp_path):
    bits = torch.tensor([0, 0x8000, 0x3F80, 0x7F80, 0xFF80, 0x0001, 0x7F7F,
                         0x3E9A, 0xC2F7], dtype=torch.int32).to(torch.int16)
    x = bits.view(torch.bfloat16)
    tree = {"h": x, "g": torch.randn(3, 5, generator=torch.Generator()
                                     .manual_seed(0)).to(torch.bfloat16)}
    save_checkpoint(str(tmp_path), 0, tree)
    with np.load(tmp_path / "ckpt_00000000.npz") as data:
        assert data["['h']"].dtype == np.float32
    back = restore_checkpoint(str(tmp_path), 0, ck._rebuild(
        tree, lambda _, t: torch.zeros_like(t)))
    for k in tree:
        assert back[k].dtype == torch.bfloat16
        assert torch.equal(back[k].view(torch.int16), tree[k].view(torch.int16))
    with open(tmp_path / "ckpt_structure.json") as f:
        assert json.load(f)["['h']"] == {"shape": [9], "dtype": "bfloat16"}


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_bfloat16_leaves_interchange_bit_for_bit(tmp_path, writer):
    """JAX writes a bfloat16 leaf as its raw 16 bits, the port as its exact
    f32: each package restores the other's onto a bfloat16 template."""
    bits = np.array([0, 0x8000, 0x3FC0, 0xC010, 0x7F80, 0x0001, 0x3B45],
                    np.uint16)
    x = torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16)
    jx = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
    assert np.array_equal(np.asarray(jx).view(np.uint16), bits)
    if writer == "jax":
        jax_save(str(tmp_path), 1, {"h": jx})
        back = restore_checkpoint(str(tmp_path), 1,
                                  {"h": torch.zeros(7, dtype=torch.bfloat16)})
        got = back["h"].view(torch.int16).numpy().view(np.uint16)
    else:
        save_checkpoint(str(tmp_path), 1, {"h": x})
        back = jax_restore(str(tmp_path), 1, {"h": jnp.zeros(7, jnp.bfloat16)})
        assert back["h"].dtype == jnp.bfloat16
        got = np.asarray(back["h"]).view(np.uint16)
    assert np.array_equal(got, bits)


# ---------------------------------------------------------------------------
# a tree-layout chunked run saved and restored mid-run
# ---------------------------------------------------------------------------

RATES = dict(nan_rate=0.08, explode_rate=0.05, byzantine_rate=0.05,
             overstale_rate=0.08)
CLIP, BETA, LR, SEED = 5.0, 3.0, 0.05, 1


def test_tree_chunked_run_resumes_bit_for_bit(tmp_path):
    """tests/test_faults.py::test_fault_counters_survive_chunk_and_resume's
    tree case on the port: chunks of 16 events with a save and restore in
    the middle equal the straight chunked run, every carry tensor bit for
    bit, and the one-shot runner's guard counters."""
    cfg = get_config("yi-9b").reduced(layers=2, d_model=64, vocab=128)
    task = make_lm_task(cfg=cfg, n_clients=4, batch=2, seq=32,
                        n_tokens=1 << 14, seed=0, device="cpu")
    n, t_final, C = 4, 16, 16
    n_pad = -(-(default_n_events(ACED(tau_algo=6), t_final) + 32) // C) * C
    rand = build_staleness_randomness(SEED, n_pad, n, BETA, device="cpu")
    noise = build_payload_noise(task.grad_fn, SEED, n_pad, n, device="cpu")
    fa = build_fault_schedule(SEED, n_pad, device="cpu", **RATES)
    kw = dict(grad_fn=task.grad_fn, params0=task.params0, n_clients=n,
              T=t_final, beta=BETA, layout="tree", guards=True,
              resync_every=4, device="cpu")

    _, _, outs, _ = make_staleness_runner(aggregator=ACED(tau_algo=6), **kw)(
        rand, noise, LR, fa, CLIP)
    want = {k: int(outs[k].sum()) for k in ("quarantined", "clipped",
                                            "rejected")}

    runner = make_chunked_staleness_runner(capacity=C,
                                           aggregator=ACED(tau_algo=6), **kw)

    def chunks(carry, lo, hi):
        for o in range(lo, hi, C):
            carry, _ = runner.chunk(carry, rand.slice(o, o + C),
                                    noise.ticks[o:o + C], LR,
                                    fa.slice(o, o + C), CLIP)
        return carry

    straight = chunks(runner.init(LR, noise.init), 0, n_pad)
    mid = (n_pad // C // 2) * C
    save_train_checkpoint(tmp_path, mid,
                          chunks(runner.init(LR, noise.init), 0, mid))
    restored, e0 = restore_train_checkpoint(tmp_path,
                                            runner.init(LR, noise.init))
    assert e0 == mid == int(restored["e"])
    resumed = chunks(restored, mid, n_pad)
    got = {k: int(v) for k, v in resumed["guards"].items()}
    assert got == want
    assert sum(got.values()) > 0, "the schedule injected nothing in-window"
    pairs = list(zip(ck._paths(resumed), ck._paths(straight)))
    assert len(pairs) > 30
    for (ka, a), (kb, b) in pairs:
        assert ka == kb and _same(a, b), ka
