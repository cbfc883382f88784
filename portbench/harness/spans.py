"""The program's own spans (`repro_torch.trace`, host ranges of the
profiler's trace) and the device's time put down to them.

A device operation is under a span when the runtime call that launched it
(the host event of the same correlation id, a ``cu…`` call) starts inside
the span's host range. A forward's backward runs later, on autograd's own
thread, outside the forward's range; so an operation launched inside an
``autograd::engine::evaluate_function`` event is also under a span whose
forward recorded that event's sequence number (the host operations that
ran inside the span's range, on its thread, hold a range of sequence
numbers, and each backward function carries the number of the forward
operation it undoes). Device busy inside a span is the part of its host
range in which some device operation ran, and its idle the rest.

`read` takes these from a finished profile; `busy_inside` and
`idle_inside` read a `harness.trace.Record` alone; `tick_split` and
`outside_init_ms` are the split of an uncaptured call's tick and the
captured call's device time that it is held against.
"""
from __future__ import annotations

import bisect
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

#: the tick's children in the order they run (`repro_torch.trace`)
TICK_CHILDREN = ("tick.sample", "tick.ring_read", "tick.payload",
                 "tick.rule", "tick.apply", "tick.ring_write", "tick.outs",
                 "tick.carry")
#: the children that are the server's: the stale reads, the rule, the
#: update, the ring's write and the new state copied into the carry
SERVER = ("tick.ring_read", "tick.rule", "tick.apply", "tick.ring_write",
          "tick.carry")
INIT_CHILDREN = ("init.payload", "init.rule_state", "init.ring")
RUNNER = ("runner.feed", "runner.init", "runner.ticks")
NAMES = frozenset(("tick", "ssd.chunked") + RUNNER + TICK_CHILDREN
                  + INIT_CHILDREN)
ENGINE = "autograd::engine::evaluate_function"

Range = Tuple[int, int]


class Spans:
    """What a trace holds for the rules above: the device operations
    (``ops``: start, end, correlation id), the start and thread of each
    runtime call by correlation id (``launches``), the program's spans
    (``ranges``: name -> [(start, end, thread)]), the backward functions
    (``backward``: [(start, end, thread, sequence number)]) and the
    host operations' sequence numbers (``forward``: thread -> [(start,
    sequence number)], in start order)."""

    def __init__(self):
        self.ops: List[Tuple[int, int, int]] = []
        self.launches: Dict[int, Tuple[int, int]] = {}
        self.ranges: Dict[str, List[Tuple[int, int, int]]] = {}
        self.backward: List[Tuple[int, int, int, int]] = []
        self.forward: Dict[int, List[Tuple[int, int]]] = {}


def _runtime_call(name: str) -> bool:
    return name.startswith("cu") and "::" not in name


def read(prof) -> Spans:
    """The `Spans` of a finished torch.profiler profile, read straight
    from its kineto results. A user annotation mirrored on the device's
    timeline is no device operation."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    sp = Spans()
    for e in prof.profiler.kineto_results.events():
        if getattr(e, "is_hidden_event", lambda: False)():
            continue
        start, end = e.start_ns(), e.end_ns()
        if e.device_type() == cuda:
            if not getattr(e, "is_user_annotation", lambda: False)():
                sp.ops.append((start, end, e.correlation_id()))
            continue
        name, thread = e.name(), e.start_thread_id()
        if name in NAMES:
            sp.ranges.setdefault(name, []).append((start, end, thread))
        elif name.startswith(ENGINE):
            sp.backward.append((start, end, thread, e.sequence_nr()))
        elif _runtime_call(name):
            sp.launches[e.correlation_id()] = (start, thread)
        elif e.sequence_nr() >= 0:
            sp.forward.setdefault(thread, []).append((start,
                                                      e.sequence_nr()))
    for v in sp.ranges.values():
        v.sort()
    for v in sp.forward.values():
        v.sort()
    return sp


def _inside(t: int, ranges: Sequence[Range], starts: Sequence[int]) -> bool:
    """Whether `t` lies in one of the sorted, disjoint `ranges`."""
    i = bisect.bisect_right(starts, t) - 1
    return i >= 0 and t <= ranges[i][1]


def _merged(ranges: Iterable[Range]) -> List[List[int]]:
    out: List[List[int]] = []
    for s, e in sorted(ranges):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def backward_of(sp: Spans, name: str) -> Dict[int, List[Range]]:
    """The backward functions of the operations that ran inside `name`'s
    ranges, by sequence number -> thread -> their sorted host ranges."""
    seqs: List[Range] = []
    for start, end, thread in sp.ranges.get(name, []):
        fwd = sp.forward.get(thread, [])
        lo = bisect.bisect_left(fwd, (start, -1))
        hi = bisect.bisect_right(fwd, (end, 1 << 62))
        if hi > lo:
            nums = [s for _, s in fwd[lo:hi]]
            seqs.append((min(nums), max(nums)))
    seqs = [tuple(r) for r in _merged(seqs)]
    firsts = [r[0] for r in seqs]
    out: Dict[int, List[Range]] = {}
    for start, end, thread, seq in sp.backward:
        if seq >= 0 and _inside(seq, seqs, firsts):
            out.setdefault(thread, []).append((start, end))
    return {k: sorted(v) for k, v in out.items()}


class _Under:
    """Whether a host time (on a thread) lies under a span: inside one of
    its ranges (any thread) or, with `backward`, inside a backward function
    of its forward on that thread."""

    def __init__(self, sp: Spans, name: str, backward: bool = False):
        self.ranges = [(s, e) for s, e, _ in sp.ranges.get(name, [])]
        self.starts = [r[0] for r in self.ranges]
        self.back = backward_of(sp, name) if backward else {}
        self.back_starts = {k: [r[0] for r in v] for k, v in self.back.items()}

    def __call__(self, t: int, thread: int) -> bool:
        if _inside(t, self.ranges, self.starts):
            return True
        back = self.back.get(thread)
        return back is not None and _inside(t, back, self.back_starts[thread])


def device_ms(sp: Spans, name: str, backward: bool = False,
              within: Optional[str] = None) -> float:
    """Device ms of the operations under span `name` (with `backward`, its
    forward's backward functions' too), and under `within` as well where
    given; 0.0 where the trace has no such span."""
    under = _Under(sp, name, backward)
    also = _Under(sp, within) if within else None
    ns = 0
    for start, end, corr in sp.ops:
        launch = sp.launches.get(corr)
        if launch is None or not under(*launch):
            continue
        if also is None or also(*launch):
            ns += end - start
    return ns / 1e6


def tick_split(sp: Spans, ticks: int) -> Optional[Dict[str, float]]:
    """The device ms a tick of an uncaptured call's trace, by span, over
    its `ticks` eager ticks: ``tick``, each child, ``payload``
    (``tick.payload``), ``server`` (`SERVER`), ``ssd`` (``ssd.chunked``,
    forward and backward, inside ``tick.payload``) and ``coverage``, the
    share (%) of ``tick``'s device ms its children hold. None where the
    trace has no tick."""
    if not ticks or not sp.ranges.get("tick"):
        return None
    ms = {k: device_ms(sp, k) / ticks for k in ("tick",) + TICK_CHILDREN}
    out = dict(ms)
    out["payload"] = ms["tick.payload"]
    out["server"] = sum(ms[k] for k in SERVER)
    out["ssd"] = device_ms(sp, "ssd.chunked", backward=True,
                           within="tick.payload") / ticks
    out["coverage"] = (100.0 * sum(ms[k] for k in TICK_CHILDREN)
                       / ms["tick"] if ms["tick"] else None)
    return out


def outside_init_ms(sp: Spans) -> float:
    """Device ms of a call's operations not launched inside
    ``runner.init``."""
    total = sum(e - s for s, e, _ in sp.ops) / 1e6
    return total - device_ms(sp, "runner.init")


def busy_inside(record, names: Sequence[str]) -> Dict[str, Range]:
    """Of each named span of a `harness.trace.Record` (its host ranges of
    that name, summed): (host ns, ns of them in which some device interval
    of the record lies)."""
    busy = _merged(record.intervals)
    starts = [b[0] for b in busy]
    # before[i]: the busy ns of the merged intervals before the i-th
    before = [0]
    for s, e in busy:
        before.append(before[-1] + e - s)

    def busy_until(t):
        i = bisect.bisect_right(starts, t)
        if i == 0:
            return 0
        s, e = busy[i - 1]
        return before[i - 1] + min(t, e) - s

    want = set(names)
    out = dict.fromkeys(names, (0, 0))
    for s, e, name in record.host:
        if name in want:
            host, dev = out[name]
            out[name] = (host + e - s, dev + busy_until(e) - busy_until(s))
    return out


def idle_inside(record, names: Sequence[str]) -> Dict[str, float]:
    """Seconds of device idle inside each named span of a
    `harness.trace.Record`: its host ranges' length less `busy_inside`."""
    return {k: (host - dev) / 1e9
            for k, (host, dev) in busy_inside(record, names).items()}


def runtime_inside(record, name: str, top: int = 3) -> List[Tuple[str,
                                                                 float]]:
    """The `top` runtime calls (``cu…``) by host seconds that started
    inside span `name`'s host ranges in a `harness.trace.Record`, summed by
    call name: the allocator's and the synchronising calls among them are
    where the host, and so the device, waits."""
    ranges = sorted((s, e) for s, e, n in record.host if n == name)
    starts = [r[0] for r in ranges]
    by: Dict[str, int] = {}
    for s, e, n in record.host:
        if _runtime_call(n) and _inside(s, ranges, starts):
            by[n] = by.get(n, 0) + e - s
    return [(n, ns / 1e9) for n, ns in
            sorted(by.items(), key=lambda kv: -kv[1])[:top]]
