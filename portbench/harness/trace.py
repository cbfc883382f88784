"""Reading a torch.profiler trace of runner calls: the device operations by
name (launches, device seconds), the union of their intervals, the idle
gaps between them labelled by what the host was doing, and the check that
the trace kept every launch of the port's own kernels.

The profiler on the card at times loses device events of a long trace (a
replayed kernel seen fewer times than the graph ran it). A trace whose
count of the port's kernels differs from the program's launch counters is
therefore taken again, `TRACE_ATTEMPTS` traces in all; a difference that
every trace shows fails the run.
"""
from __future__ import annotations

import re
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

TRACE_ATTEMPTS = 3

#: the CUDA functions each of the port's kernels launches, as a pattern
#: matched where a name starts (`symbol_matches`): quantize_rows' cluster
#: and grid kernels, never dequantize_rows_kernel
KERNEL_SYMBOLS = {"row_delta": "row_delta",
                  "cache_row_update": "cache_update",
                  "commit_batch": "commit_batch_kernel",
                  "masked_agg": "masked_agg_kernel",
                  "quantize_rows": "quantize_rows_(?:grid_)?kernel",
                  "dequantize_rows": "dequantize_rows_kernel"}


def symbol_matches(symbol: str, name: str) -> bool:
    """Whether a device operation `name` is one of `symbol`'s (a pattern of
    `KERNEL_SYMBOLS`), matched where a name starts."""
    return re.search(r"(?<![A-Za-z_])" + symbol, name) is not None


class Record:
    """What one traced call left: the device operations summed by name
    (``rows``: name -> [launches, device seconds]), their intervals, the
    host operations' intervals, and the call's host-clock seconds."""

    def __init__(self):
        self.rows: Dict[str, List[float]] = {}
        self.intervals: List[Tuple[int, int]] = []
        self.host: List[Tuple[int, int, str]] = []
        self.wall_s = 0.0


def read_trace(prof) -> Record:
    """The device and host events of a finished profile, read straight
    from the profiler's kineto results (faster than `key_averages()` over a
    long trace by an order of magnitude)."""
    from torch.autograd.profiler_util import _rewrite_name
    rec = Record()
    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.profiler.kineto_results.events():
        if getattr(e, "is_hidden_event", lambda: False)():
            continue
        start, end = e.start_ns(), e.end_ns()
        if e.device_type() != cuda:
            if end > start:
                rec.host.append((start, end, e.name()))
            continue
        key = _rewrite_name(name=e.name(), with_wildcard=True)
        row = rec.rows.setdefault(key, [0, 0.0])
        row[0] += 1
        if end > start:
            row[1] += (end - start) / 1e9
            rec.intervals.append((start, end))
    return rec


def busy_seconds(intervals) -> float:
    """The length of the union of the device intervals."""
    total, cur_s, cur_e = 0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e9


#: gaps shorter than this (ns) are the device's own spacing between the
#: operations of one launch stream or graph, summed under one label
SHORT_GAP_NS = 5000
#: host operations searched back from a gap for the one around it
HOST_LOOKBACK = 400
#: the longest name a breakdown keeps of an operation
NAME_CHARS = 160


def idle_gaps(rec: Record, top: int = 10) -> List[List]:
    """The idle time between device operations summed by what the host was
    doing at each gap's middle (the shortest host operation around it, of
    the `HOST_LOOKBACK` that started last before it), the largest `top`;
    gaps under `SHORT_GAP_NS` summed as one."""
    import bisect
    merged = []
    for s, e in sorted(rec.intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    host = sorted(rec.host)
    starts = [h[0] for h in host]
    short = f"gaps under {SHORT_GAP_NS / 1000:g} us between device operations"
    by_label: Dict[str, float] = {}
    for (_, a), (b, _) in zip(merged, merged[1:]):
        if b - a < SHORT_GAP_NS:
            label = short
        else:
            mid = (a + b) // 2
            i = bisect.bisect_right(starts, mid)
            around = [h for h in host[max(0, i - HOST_LOOKBACK):i]
                      if h[1] >= mid]
            label = (min(around, key=lambda h: h[1] - h[0])[2][:NAME_CHARS]
                     if around else "no host operation")
        by_label[label] = by_label.get(label, 0.0) + (b - a) / 1e9
    return [[k, v] for k, v in sorted(by_label.items(),
                                      key=lambda kv: -kv[1])[:top]]


def top_ops(rec: Record, top: int = 10) -> List[List]:
    """The `top` device operations by device seconds (names cut to
    `NAME_CHARS`)."""
    return [[k[:NAME_CHARS], v[1]]
            for k, v in sorted(rec.rows.items(),
                               key=lambda kv: -kv[1][1])[:top]]


def port_launches(rec: Record) -> Dict[str, int]:
    return {name: int(sum(v[0] for k, v in rec.rows.items()
                          if symbol_matches(sym, k)))
            for name, sym in KERNEL_SYMBOLS.items()}


def traced_call(call: Callable, reset_counts: Callable,
                counts: Callable, log=print) -> Tuple[Record, object]:
    """One call of `call()` traced, again while its trace lost launches of
    the port's kernels (`TRACE_ATTEMPTS` in all) -> (the record, the
    call's result). `reset_counts()` zeroes and `counts()` reads the
    program's launch counters."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    off: Optional[Dict] = None
    for attempt in range(1, TRACE_ATTEMPTS + 1):
        out = None
        reset_counts()
        with torch.profiler.profile(activities=acts) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = call()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        rec = read_trace(prof)
        rec.wall_s = wall
        expected, seen = counts(), port_launches(rec)
        off = {k: (seen[k], expected[k]) for k in expected
               if seen.get(k, 0) != expected[k]}
        if not off:
            return rec, out
        log(f"trace {attempt} lost launches (seen, counted): {off}")
        del out
    raise RuntimeError(f"every one of {TRACE_ATTEMPTS} traces lost launches "
                       f"(seen, counted): {off}")
