"""The span readers (`harness.spans`, `metrics/init_idle_ms_per_call.py`,
`metrics/init_busy_ms_per_call.py`) on the CPU: the attribution rules on
hand-built records (by correlation, by sequence number for a backward,
the idle and the busy inside ``runner.init``), the
readers on them, and a real CPU profile of a tiny model's `ssd_chunked`
forward and backward."""
import importlib
from types import SimpleNamespace

import pytest
import torch

from harness import spans, trace


def _spans(ranges, ops, launches, backward=(), forward=None):
    sp = spans.Spans()
    for name, s, e, th in ranges:
        sp.ranges.setdefault(name, []).append((s, e, th))
    for v in sp.ranges.values():
        v.sort()
    sp.ops, sp.launches = list(ops), dict(launches)
    sp.backward = list(backward)
    sp.forward = {k: sorted(v) for k, v in (forward or {}).items()}
    return sp


def _tick(t0):
    """One tick's spans from `t0` on thread 1, every child 100 ns wide."""
    out = [("tick", t0, t0 + 800, 1)]
    for i, name in enumerate(spans.TICK_CHILDREN):
        out.append((name, t0 + 100 * i, t0 + 100 * i + 99, 1))
    return out


def test_a_device_operation_is_under_the_span_its_launch_started_in():
    # two ticks; one op launched in each child of each tick, 10 ns long
    # but the payload's, 1000 ns; one launched outside any tick; one whose
    # runtime call the trace lost
    ranges = _tick(0) + _tick(1000)
    ops, launches, corr = [], {}, 0
    for t0 in (0, 1000):
        for i, name in enumerate(spans.TICK_CHILDREN):
            corr += 1
            dur = 1000 if name == "tick.payload" else 10
            ops.append((50_000 + corr * 2000, 50_000 + corr * 2000 + dur,
                        corr))
            launches[corr] = (t0 + 100 * i + 50, 1)
    ops += [(90_000, 90_500, 100), (91_000, 91_700, 101)]
    launches[100] = (950, 1)            # between the ticks
    sp = _spans(ranges, ops, launches)
    assert spans.device_ms(sp, "tick") == pytest.approx(2 * 1070 / 1e6)
    assert spans.device_ms(sp, "tick.payload") == pytest.approx(2e-3)
    assert spans.device_ms(sp, "runner.init") == 0.0
    split = spans.tick_split(sp, 2)
    assert split["payload"] == pytest.approx(1e-3)
    assert split["server"] == pytest.approx(5 * 10 / 1e6)
    assert split["tick.outs"] == pytest.approx(1e-5)
    assert split["coverage"] == pytest.approx(100.0)
    assert split["ssd"] == 0.0
    assert spans.tick_split(sp, 0) is None
    assert spans.tick_split(_spans([], ops, launches), 2) is None
    # everything but what runner.init launched: here, every operation
    assert spans.outside_init_ms(sp) == pytest.approx(
        (2 * 1070 + 500 + 700) / 1e6)


def test_a_backward_is_under_the_span_whose_forward_it_undoes():
    # tick.payload on thread 1 holds two ssd.chunked forwards (sequence
    # numbers 10-12 and 20-21) and a loss (30); autograd's thread 2 runs
    # the backward functions inside the payload's range
    ranges = [("tick", 0, 10_000, 1), ("tick.payload", 100, 9_000, 1),
              ("ssd.chunked", 200, 300, 1), ("ssd.chunked", 400, 500, 1)]
    forward = {1: [(210, 10), (220, 11), (290, 12), (410, 20), (450, 21),
                   (600, 30)]}
    backward = [(1000, 1100, 2, 30), (1200, 1300, 2, 21),
                (1400, 1500, 2, 11), (1600, 1700, 2, 5),
                (1800, 1900, 2, -1)]
    launches = {1: (250, 1), 2: (1050, 2), 3: (1250, 2), 4: (1450, 2),
                5: (1650, 2), 6: (1850, 2), 7: (1450, 3)}
    ops = [(20_000 + 1000 * c, 20_000 + 1000 * c + 100 * c, c)
           for c in launches]
    sp = _spans(ranges, ops, launches, backward, forward)
    back = spans.backward_of(sp, "ssd.chunked")
    assert back == {2: [(1200, 1300), (1400, 1500)]}
    # the forward's op (1) and the two backward functions' (3, 4); not the
    # loss's backward (2), an unrelated one (5), AccumulateGrad's (6), nor
    # an op launched on another thread at a backward's time (7)
    assert spans.device_ms(sp, "ssd.chunked", backward=True) == \
        pytest.approx((100 + 300 + 400) / 1e6)
    assert spans.device_ms(sp, "ssd.chunked") == pytest.approx(1e-4)
    # within the payload: the same; within a span that holds none: 0
    assert spans.device_ms(sp, "ssd.chunked", backward=True,
                           within="tick.payload") == pytest.approx(8e-4)
    assert spans.device_ms(sp, "ssd.chunked", backward=True,
                           within="tick.rule") == 0.0
    assert spans.tick_split(sp, 1)["ssd"] == pytest.approx(8e-4)


def _record(intervals, host, wall):
    rec = trace.Record()
    rec.intervals, rec.host, rec.wall_s = list(intervals), list(host), wall
    return rec


def test_idle_inside_runner_init_and_its_reader(capsys):
    # one call of 10_000 ns: feed 0-1000, init 1000-6000 (payload
    # 1000-3000, rule state 3000-5000, ring 5000-6000), ticks 6000-9000;
    # the device busy 0-500, 1500-2500, 3000-3200, 5000-9500
    host = [(0, 1000, "runner.feed"), (1000, 6000, "runner.init"),
            (1000, 3000, "init.payload"), (3000, 5000, "init.rule_state"),
            (5000, 6000, "init.ring"), (6000, 9000, "runner.ticks"),
            (1600, 1700, "aten::mm"), (1100, 1400, "cudaMalloc"),
            (3300, 3400, "cudaMalloc"), (1650, 1660, "cudaLaunchKernel"),
            (7000, 7900, "cudaFree")]
    busy = [(0, 500), (1500, 2500), (3000, 3200), (5000, 9500)]
    rec = _record(busy, host, 10_000 / 1e9)
    idle = spans.idle_inside(rec, spans.RUNNER + spans.INIT_CHILDREN)
    assert idle["runner.feed"] == pytest.approx(500e-9)
    assert idle["init.payload"] == pytest.approx(1000e-9)
    assert idle["init.rule_state"] == pytest.approx(1800e-9)
    assert idle["init.ring"] == 0.0
    assert idle["runner.init"] == pytest.approx(2800e-9)
    assert idle["runner.ticks"] == 0.0
    read = importlib.import_module("metrics.init_idle_ms_per_call").read
    run = SimpleNamespace(record=rec, calls=2, ticks=128, wall_s=rec.wall_s)
    assert read(run) == pytest.approx(2800e-6 / 2)
    log = capsys.readouterr().err
    assert "init.rule_state 0.001" in log and "(86.84 % inside them)" in log
    # the init's runtime calls, longest first; the ticks' free is not one
    assert "calls cudaMalloc 0.000, cudaLaunchKernel 0.000;" in log
    assert "cudaFree" not in log
    assert spans.runtime_inside(rec, "runner.init", top=1) == [
        ("cudaMalloc", pytest.approx(400e-9))]
    # a program without the span: nothing to read
    parent = _record(busy, [h for h in host if not h[2].startswith(
        ("runner.", "init."))], rec.wall_s)
    assert read(SimpleNamespace(record=parent, calls=1, ticks=64,
                                wall_s=rec.wall_s)) is None


def test_busy_inside_runner_init_and_its_reader(capsys):
    # the record of the test above: init 1000-6000 holds the busy
    # 1500-2500, 3000-3200 and 5000-6000 of 5000-9500
    host = [(0, 1000, "runner.feed"), (1000, 6000, "runner.init"),
            (6000, 9000, "runner.ticks"), (1600, 1700, "aten::mm")]
    busy = [(0, 500), (1500, 2500), (3000, 3200), (5000, 9500)]
    rec = _record(busy, host, 10_000 / 1e9)
    assert spans.busy_inside(rec, ("runner.init", "runner.ticks",
                                   "init.ring")) == {
        "runner.init": (5000, 2200), "runner.ticks": (3000, 3000),
        "init.ring": (0, 0)}
    # two ranges of one name are summed
    twice = _record(busy, host + [(9000, 9600, "runner.init")], rec.wall_s)
    assert spans.busy_inside(twice, ("runner.init",)) == {
        "runner.init": (5600, 2700)}
    read = importlib.import_module("metrics.init_busy_ms_per_call").read
    run = SimpleNamespace(record=rec, calls=2, ticks=128, wall_s=rec.wall_s)
    assert read(run) == pytest.approx(2200e-6 / 2)
    assert "runner.init 0.003 host ms a call, 0.001 of them busy" in \
        capsys.readouterr().err
    parent = _record(busy, host[3:], rec.wall_s)
    assert read(SimpleNamespace(record=parent, calls=1, ticks=64,
                                wall_s=rec.wall_s)) is None


def test_a_cpu_profile_puts_ssd_backward_ops_under_ssd_chunked():
    """The model's `ssd_chunked` forward and backward profiled on the CPU:
    the aten operations of its backward, run outside its range, are under
    ``ssd.chunked`` by their backward functions' sequence numbers; the
    loss's forward and backward outside it are not."""
    from repro_torch.models.ssm import ssd_chunked
    from torch.profiler import ProfilerActivity, profile
    g = torch.Generator().manual_seed(0)
    B, L, H, P, G, N = 1, 16, 2, 4, 1, 4
    x, a, Bm, Cm = (torch.randn(s, generator=g).requires_grad_(True)
                    for s in ((B, L, H, P), (B, L, H), (B, L, G, N),
                              (B, L, G, N)))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        y, _ = ssd_chunked(x, -a.abs(), Bm, Cm, SimpleNamespace(ssm_chunk=8))
        (y.square().sum() * 3.0).backward()
    sp = spans.read(prof)
    (ssd,) = sp.ranges["ssd.chunked"]
    under = spans._Under(sp, "ssd.chunked", backward=True)
    ops = [(e.name(), e.start_ns(), e.start_thread_id())
           for e in prof.profiler.kineto_results.events()
           if e.name().startswith("aten::")]
    inside = [o for o in ops if ssd[0] <= o[1] <= ssd[1]]
    after = [o for o in ops if o[1] > ssd[1]]
    back = [o for o in after if under(o[1], o[2])]
    assert inside and all(under(o[1], o[2]) for o in inside)
    # the backward's products and element-wise passes are the span's ...
    assert {"aten::bmm", "aten::mul"} & {o[0] for o in back}
    # ... and the loss's own (its square, its product by 3) are not
    assert [o for o in after if not under(o[1], o[2])]
    assert not under(ssd[0] - 1, ssd[2])
    nums = {s for _, s in sp.forward[ssd[2]]}
    fwd = [s for t, s in sp.forward[ssd[2]] if ssd[0] <= t <= ssd[1]]
    got = {s for _, _, _, s in sp.backward
           if min(fwd) <= s <= max(fwd)}
    assert got and got <= nums
