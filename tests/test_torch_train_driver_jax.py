"""The port's train driver and the JAX package's on one trajectory, on the
CPU: the reduced yi LM task of tests/test_torch_lm_task.py (2 layers,
d_model 64, vocab 128; n = 4 clients, batch 2, seq 32), ACE with f32
caches, T = 12, driven through each package's `launch.train.main`. Both
drivers get the same task (JAX's weights; JAX's gradient drawing its
windows by the port's rule, `jax_lm_grad`) and the same streams (the port
replays JAX's gumbels, staleness and payload-noise key chain,
`replay_streams`), by monkeypatching the names each driver's module looks
up; no file of `src/repro` changes. The final losses agree within 1e-5.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import aggregators as jagg  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from test_torch_engine import replay_streams  # noqa: E402
from test_torch_lm_task import TASK, jax_lm_grad, tasks  # noqa: E402

torch.set_num_threads(1)

ARGS = ["--arch", "yi-9b", "--reduced", "--d-model", "64", "--layers", "2",
        "--vocab", "128", "--seq", str(TASK["seq"]), "--batch",
        str(TASK["batch"]), "--n-clients", str(TASK["n_clients"]),
        "--steps", "12", "--algo", "ace", "--beta", "3.0", "--chunk-events",
        "5", "--log-every", "4"]


def test_the_two_drivers_run_one_trajectory(monkeypatch, capsys):
    jtask, ttask, params0 = tasks()
    jgrad, noise_of = jax_lm_grad()
    monkeypatch.setattr(jtrain, "make_lm_task", lambda **kw: dataclasses.replace(
        jtask, grad_fn=jgrad))
    monkeypatch.setattr(ttrain, "make_lm_task", lambda **kw: dataclasses.replace(
        ttask, params0=params0))
    streams = {}

    def replayed(seed, n_events, n_clients, beta, speed_skew=0.0, k_batch=1,
                 device=None):
        assert speed_skew == 0.0 and device == torch.device("cpu")
        wants_init = jagg.wants_cache_init(jagg.ACEIncremental())
        streams["rand"], streams["noise"] = replay_streams(
            seed, n_events, n_clients, beta, k_batch, noise_of,
            (TASK["batch"],), wants_init)
        return streams["rand"]

    monkeypatch.setattr(ttrain, "build_staleness_randomness", replayed)
    monkeypatch.setattr(ttrain, "build_payload_noise",
                        lambda *a, **kw: streams["noise"])

    jfinal = jtrain.main(ARGS)
    tfinal = ttrain.main(ARGS + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert out.count("t=   12/12 events=11") == 2
    assert np.isfinite(tfinal)
    assert abs(tfinal - jfinal) <= 1e-5, (tfinal, jfinal)
