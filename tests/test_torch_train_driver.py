"""The port's train driver (`repro_torch.launch.train`) on the CPU:

  * tests/test_system.py's train cases on the port: the reduced gemma2 LM
    (ACE, here with an int8 cache) reaches a final loss below 5.75 in 120
    steps with checkpoints every 60 events; a run resumes from its
    checkpoint; ACE, FedBuff and ASGD on a reduced mamba2;
  * resume bit for bit: keep only the straight run's checkpoint before its
    last and resume — the final checkpoint's carry equals the straight
    run's, leaf for leaf; with the newest checkpoint truncated to half its
    size, the run warns, falls back to the one before it and ends the same;
  * ``--driver host`` (the host reference `StalenessSimulator` on the same
    streams) against the chunked engine with f32 caches: final losses
    within 1e-5;
  * the driver's final carry equals a direct `make_chunked_staleness_runner`
    run with the same settings and streams, bit for bit;
  * a faulted run (NaN payloads, the clip and resync) prints its guard
    counters, and a checkpoint whose carry is at another event than its
    name raises.
"""
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.checkpoint import restore_train_checkpoint  # noqa: E402
import repro_torch.checkpoint.checkpoint as ck  # noqa: E402
from repro_torch.configs.registry import afl_config, get_config  # noqa: E402
from repro_torch.core.aggregators import make_aggregator  # noqa: E402
from repro_torch.core.fl_tasks import make_lm_task  # noqa: E402
from repro_torch.core.scan_engine import (build_payload_noise,  # noqa: E402
                                          default_n_events)
from repro_torch.core.scan_staleness import (  # noqa: E402
    build_staleness_randomness, make_chunked_staleness_runner)
from repro_torch.core.staleness_sim import default_tau_max  # noqa: E402
from repro_torch.launch.train import main as train_main  # noqa: E402
from repro_torch.optim import sqrt_nt_schedule  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


GEMMA = ["--arch", "gemma2-2b", "--reduced", "--d-model", "128", "--layers",
         "2", "--vocab", "256", "--seq", "64", "--batch", "8", "--steps",
         "120", "--algo", "ace", "--n-clients", "4", "--lr-scale", "1.0",
         "--log-every", "60", "--ckpt-every", "60", "--cache-dtype", "int8",
         "--device", "cpu"]
SMALL_YI = ["--arch", "yi-9b", "--reduced", "--d-model", "64", "--layers",
            "2", "--vocab", "128", "--seq", "32", "--batch", "2",
            "--n-clients", "4", "--log-every", "50", "--device", "cpu"]


def _npz(directory, step):
    return os.path.join(directory, f"afl_{step:08d}.npz")


def _same_file_arrays(a, b):
    with np.load(a) as x, np.load(b) as y:
        assert sorted(x.files) == sorted(y.files)
        for k in x.files:
            assert x[k].dtype == y[k].dtype and np.array_equal(
                x[k].reshape(-1).view(np.uint8),
                y[k].reshape(-1).view(np.uint8)), k
        return len(x.files)


@pytest.fixture(scope="module")
def straight(tmp_path_factory):
    """The reduced gemma2 run of tests/test_system.py with an int8 cache:
    (its checkpoint directory, its final loss)."""
    d = str(tmp_path_factory.mktemp("straight"))
    return d, train_main(GEMMA + ["--ckpt-dir", d])


def test_train_driver_loss_decreases(straight):
    _, final = straight
    # ~ln(256) + 0.4 at init: clear progress in 120 ACE steps
    assert final < 5.75


def test_resume_is_bit_for_bit(straight, tmp_path, capsys):
    src, final = straight
    steps = ck._all_steps(src, "afl")
    assert steps == [64, 119]
    d = str(tmp_path / "resumed")
    shutil.copytree(src, d)
    for suffix in ("", ".sha256"):
        os.remove(_npz(d, steps[-1]) + suffix)
    train_main(GEMMA + ["--ckpt-dir", d])
    assert "resumed from event 64" in capsys.readouterr().out
    assert _same_file_arrays(_npz(d, 119), _npz(src, 119)) > 20


def test_truncated_newest_checkpoint_falls_back(straight, tmp_path, capsys):
    src, _ = straight
    d = str(tmp_path / "truncated")
    shutil.copytree(src, d)
    with open(_npz(d, 119), "r+b") as f:
        f.truncate(f.seek(0, 2) // 2)
    with pytest.warns(RuntimeWarning, match="corrupt"):
        train_main(GEMMA + ["--ckpt-dir", d])
    assert "resumed from event 64" in capsys.readouterr().out
    _same_file_arrays(_npz(d, 119), _npz(src, 119))


def test_train_driver_resumes_from_checkpoint(tmp_path, capsys):
    args = SMALL_YI + ["--algo", "aced", "--ckpt-dir", str(tmp_path),
                       "--ckpt-every", "10"]
    train_main(args + ["--steps", "10"])
    final = train_main(args + ["--steps", "20"])      # resumes at 9 events
    assert "resumed from event 9" in capsys.readouterr().out
    assert np.isfinite(final)


@pytest.mark.parametrize("algo", ["ace", "fedbuff", "asgd"])
def test_train_driver_all_algorithms(algo):
    final = train_main(["--arch", "mamba2-780m", "--reduced",
                        "--d-model", "128", "--layers", "2", "--vocab", "128",
                        "--seq", "64", "--batch", "2", "--steps", "20",
                        "--algo", algo, "--n-clients", "4",
                        "--log-every", "20", "--device", "cpu"])
    assert np.isfinite(final)


def test_host_driver_matches_the_engine():
    args = SMALL_YI + ["--algo", "ace", "--steps", "16"]
    scan = train_main(args)
    host = train_main(args + ["--driver", "host"])
    assert abs(scan - host) <= 1e-5


def test_driver_carry_equals_a_direct_chunked_run(tmp_path):
    """The driver at its defaults of chunk and schedule against the runner
    built by hand from the same pieces; the final checkpoint holds the
    driver's carry."""
    T, n, C = 24, 4, 10
    train_main(SMALL_YI + ["--algo", "aced", "--steps", str(T),
                           "--chunk-events", str(C), "--k-batch", "2",
                           "--ckpt-dir", str(tmp_path)])
    cfg = get_config("yi-9b").reduced(layers=2, d_model=64, vocab=128)
    aflc = afl_config("yi-9b", algorithm="aced", n_clients=n, k_batch=2,
                      cache_dtype="float32")
    agg = make_aggregator(aflc)
    task = make_lm_task(cfg=cfg, n_clients=n, batch=2, seq=32, seed=0,
                        device="cpu")
    E = default_n_events(agg, T, True)
    rand = build_staleness_randomness(0, E, n, 5.0, k_batch=2, device="cpu")
    noise = build_payload_noise(task.grad_fn, 0, E, n, k_batch=2,
                                device="cpu")
    runner = make_chunked_staleness_runner(
        capacity=E, grad_fn=task.grad_fn, params0=task.params0,
        aggregator=agg, n_clients=n, T=T, beta=5.0,
        server_lr=sqrt_nt_schedule(0.5, n, T), tau_max=default_tau_max(5.0),
        layout="tree", k_batch=2, device="cpu")
    carry, _ = runner.chunk(runner.init(0.0, noise.init), rand, noise.ticks)
    got, e = restore_train_checkpoint(str(tmp_path),
                                      runner.init(0.0, noise.init))
    assert e == E == int(got["e"])
    pairs = list(zip(ck._paths(got), ck._paths(carry)))
    assert len(pairs) > 30
    for (ka, a), (kb, b) in pairs:
        assert ka == kb and a.dtype == b.dtype and torch.equal(a, b), ka


def test_faulted_run_prints_guard_counters(capsys):
    final = train_main(SMALL_YI + ["--algo", "aced", "--steps", "16",
                                   "--fault-nan-rate", "0.1",
                                   "--clip-norm", "1.0",
                                   "--resync-every", "4"])
    out = capsys.readouterr().out
    assert "guards on: clip_norm=1.0 resync_every=4" in out
    line = next(s for s in out.splitlines() if s.startswith("guard counters"))
    counters = eval(line.split(": ", 1)[1])
    assert set(counters) == {"quarantined", "clipped", "rejected"}
    assert counters["quarantined"] > 0 and counters["clipped"] > 0
    assert np.isfinite(final)


def test_checkpoint_at_another_event_raises(tmp_path):
    args = SMALL_YI + ["--algo", "ace", "--steps", "8", "--ckpt-dir",
                       str(tmp_path)]
    train_main(args)
    step = ck._all_steps(str(tmp_path), "afl")[-1]
    path = _npz(str(tmp_path), step)
    with np.load(path) as data:
        arrays = dict(data)
    arrays["['carry']/['e']"] = np.asarray(step + 5, np.int64)
    with open(path, "wb") as f:
        np.savez(f, **arrays)
    os.remove(path + ".sha256")         # a legacy file: verified by parsing
    with pytest.raises(RuntimeError, match="holds a carry at event"):
        train_main(args)
