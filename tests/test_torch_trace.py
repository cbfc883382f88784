"""The port's spans and its count of eager ticks (`repro_torch.trace`,
``runner.eager_ticks``) on the CPU, on the reduced
Mamba-2 LM task (2 SSD layers, d_model 64, vocab 128; n = 4 clients,
batch 2, seq 32) through the tree-layout staleness runner with an int8
cache and an int8 history ring, as tests/test_torch_cuda.py builds the
reduced zamba2 task on the card:

  * one eager runner call under ``torch.profiler.profile`` records
    ``runner.feed``, ``runner.init`` and its three children once a call,
    ``runner.ticks`` once, and inside it ``tick`` once a tick with each of
    its children once, in order and inside their tick; ``ssd.chunked``
    once a forward of each SSD layer;
  * without a profiler `span` hands back one shared null context, and a
    profiled call returns what an unprofiled one does, bit for bit;
  * the runner counts the ticks it ran eagerly, across calls and across
    a new event count, and the kernels' launch counters keep their six
    names.

The card's side (a capture under a profiler records the same graph, an
``eager=True`` call on a capturing runner) is in tests/test_torch_cuda.py
(``-k profiler or eager_call``)."""
import functools

import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch import trace  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.convert import leaves  # noqa: E402
from repro_torch.core import aggregators as tagg  # noqa: E402
from repro_torch.core.fl_tasks import make_lm_task  # noqa: E402
from repro_torch.core.scan_staleness import (  # noqa: E402
    build_payload_noise, build_staleness_randomness, make_staleness_runner)
from repro_torch.kernels import ops  # noqa: E402

N, E, LAYERS = 4, 5, 2
TICK_CHILDREN = ("tick.sample", "tick.ring_read", "tick.payload",
                 "tick.rule", "tick.apply", "tick.ring_write", "tick.outs",
                 "tick.carry")
INIT_CHILDREN = ("init.payload", "init.rule_state", "init.ring")


@functools.lru_cache(maxsize=None)
def _task():
    cfg = get_config("mamba2-780m").reduced(layers=LAYERS, d_model=64,
                                            vocab=128)
    return make_lm_task(cfg=cfg, n_clients=N, batch=2, seq=32,
                        n_tokens=1 << 14, seed=0, device="cpu")


def _runner(name="ace", K=1):
    task = _task()
    rule = (tagg.ACEIncremental(cache_dtype="int8") if name == "ace" else
            tagg.ACED(tau_algo=5, cache_dtype="int8", max_cohort=K))
    runner = make_staleness_runner(
        grad_fn=task.grad_fn, params0=task.params0, aggregator=rule,
        n_clients=N, T=16, beta=2.0, k_batch=K, layout="tree",
        history_dtype="int8", device="cpu")
    rand = build_staleness_randomness(3, E, N, 2.0, k_batch=K, device="cpu")
    noise = build_payload_noise(task.grad_fn, 3, E, N, K, device="cpu")
    return runner, rand, noise


def _spans(prof):
    """The trace's host ranges of the port's spans -> {name: [(start,
    end)]}, each list in start order."""
    names = {"runner.feed", "runner.init", "runner.ticks",
             "tick", "ssd.chunked", *TICK_CHILDREN, *INIT_CHILDREN}
    out = {}
    for e in prof.profiler.kineto_results.events():
        if e.name() in names:
            out.setdefault(e.name(), []).append((e.start_ns(), e.end_ns()))
    return {k: sorted(v) for k, v in out.items()}


def _inside(inner, outer):
    return outer[0] <= inner[0] and inner[1] <= outer[1]


def test_one_eager_call_records_every_span_in_place():
    runner, rand, noise = _runner()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        runner(rand, noise, 0.05)
    sp = _spans(prof)
    for name in ("runner.feed", "runner.init", "runner.ticks",
                 *INIT_CHILDREN):
        assert len(sp[name]) == 1, name
    (feed,), (init,), (ticks,) = (sp["runner.feed"], sp["runner.init"],
                                  sp["runner.ticks"])
    assert feed[1] <= init[0] and init[1] <= ticks[0]
    kids = [sp[k][0] for k in INIT_CHILDREN]
    assert all(_inside(k, init) for k in kids)
    assert all(a[1] <= b[0] for a, b in zip(kids, kids[1:]))
    assert len(sp["tick"]) == E
    for i, tick in enumerate(sp["tick"]):
        assert _inside(tick, ticks)
        kids = [sp[k][i] for k in TICK_CHILDREN]
        assert all(_inside(k, tick) for k in kids)
        assert all(a[1] <= b[0] for a, b in zip(kids, kids[1:]))
    for k in TICK_CHILDREN:
        assert len(sp[k]) == E, k
    # a forward of each SSD layer a lane: the init's n lanes, one a tick
    (payload,) = sp["init.payload"]
    ssd = sp["ssd.chunked"]
    assert len(ssd) == LAYERS * (N + E)
    assert sum(_inside(s, payload) for s in ssd) == LAYERS * N
    for tp in sp["tick.payload"]:
        assert sum(_inside(s, tp) for s in ssd) == LAYERS


def test_span_without_a_profiler_is_one_shared_null_context():
    a, b = trace.span("tick"), trace.span("ssd.chunked")
    assert a is b is trace._NULL
    with a:
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        c = trace.span("tick")
        assert c is not trace._NULL
        with c:
            pass


def test_a_profiled_call_returns_what_an_unprofiled_one_does():
    runner, rand, noise = _runner()
    plain = runner(rand, noise, 0.05)
    with profile(activities=[ProfilerActivity.CPU]):
        traced = runner(rand, noise, 0.05)
    eager = runner(rand, noise, 0.05, eager=True)
    for other in (traced, eager):
        assert other[0].keys() == plain[0].keys()
        for x, y in zip(leaves((plain[0], plain[1])),
                        leaves((other[0], other[1]))):
            assert x.dtype == y.dtype and torch.equal(x, y)
        assert all(torch.equal(plain[2][k], other[2][k]) for k in plain[2])


@pytest.mark.parametrize("name,K", [("ace", 1), ("aced", 3)])
def test_the_runner_counts_the_ticks_it_ran_eagerly(name, K):
    runner, rand, noise = _runner(name, K)
    assert runner.eager_ticks == 0
    runner(rand, noise, 0.05)
    assert runner.eager_ticks == E
    runner(rand, noise, 0.05, eager=True)
    assert runner.eager_ticks == 2 * E
    # another event count builds new buffers; the count goes on
    short = build_staleness_randomness(4, E - 2, N, 2.0, k_batch=K,
                                       device="cpu")
    runner(short, build_payload_noise(_task().grad_fn, 4, E - 2, N, K,
                                      device="cpu"), 0.05)
    assert runner.eager_ticks == 3 * E - 2 and runner.captures == 0
    # the kernels' counters keep their names (a trace's retake rule
    # compares each with the profiler's count of its kernel)
    assert set(ops.launch_counts()) == {
        "cache_row_update", "row_delta", "commit_batch", "masked_agg",
        "quantize_rows", "dequantize_rows"}
