"""Where a cell's tick goes, by the program's own spans, on the card:

    python3 portbench/split.py --workload <cell> --seed <n>

The port set up as a run sets it up (its warm-up call captures the tick),
then one captured call traced with torch.profiler, as a ``--trace 1`` run
traces it, then one call of the same runner uncaptured
(``runner(..., eager=True)``: the replays of the captured call run no host
code, so they carry no span of the tick) under a profiler of its own, its
result freed at once. One JSON line on standard output:

  * ``split``: the uncaptured call's device ms a tick by span
    (`harness.spans.tick_split`: ``payload``, ``server``, ``ssd``, each
    child of the tick, and ``coverage``, the share of the tick's device ms
    that its children hold), over the ticks the runner counted
    (``runner.eager_ticks``);
  * ``tick_vs_captured``: its ``tick`` device ms a tick over the captured
    call's device ms a tick outside ``runner.init``;
  * ``idle_ms``: the captured call's device idle inside the runner's spans
    and the init's children, and ``idle_owned``, the share of the call's
    idle inside ``runner.feed``, ``runner.init`` and ``runner.ticks``;
  * both calls' host-clock seconds, the uncaptured call's eager ticks, and
    the peak reserved memory before the uncaptured call and after it.

The benchmark's own runs never run this. It goes once the benchmark's
traced run makes the uncaptured call itself and its trace reader keeps
the correlation ids (PERF.md, Open questions).
"""
import argparse
import json
import os
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def traced(fn):
    """`fn()` under torch.profiler -> (profile, result, host seconds)."""
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return prof, out, wall


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(HERE))
    from run import CACHES
    for var, sub in CACHES.items():
        os.environ[var] = str(ROOT / "build" / sub)
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    from harness import cell, spans, trace
    from harness import port as port_mod
    spec = cell.load_spec(args.workload, ROOT)
    port = port_mod.load(ROOT)
    port.build.build()
    torch.cuda.reset_peak_memory_stats()
    program = cell.Program(port, spec, args.seed, "cuda")
    warm = program.call()
    del warm
    E = program.events

    port.ops.reset_launch_counts()
    prof, out, wall = traced(program.call)
    del out
    rec, cap = trace.read_trace(prof), spans.read(prof)
    del prof
    counted = port.ops.launch_counts()
    lost = {k: (v, counted[k]) for k, v in trace.port_launches(rec).items()
            if v != counted[k]}
    rec.wall_s = wall
    names = spans.RUNNER + spans.INIT_CHILDREN
    idle = spans.idle_inside(rec, names)
    call_idle = wall - trace.busy_seconds(rec.intervals)
    outside = spans.outside_init_ms(cap) / E
    del rec, cap
    peak_captured = torch.cuda.max_memory_reserved()

    cell.free()
    before = program.runner.eager_ticks
    prof, out, wall_eager = traced(lambda: program.runner(
        program.rand, program.noise, program.lr, eager=True))
    del out
    eager_ticks = program.runner.eager_ticks - before
    sp = spans.read(prof)
    del prof
    split = spans.tick_split(sp, eager_ticks)
    del sp
    print(json.dumps({
        "workload": args.workload, "seed": args.seed,
        "card": torch.cuda.get_device_name(),
        "split": split,
        "captured_outside_init_ms_per_tick": outside,
        "tick_vs_captured": (split["tick"] / outside
                             if split and outside else None),
        "idle_ms": {k: 1e3 * v for k, v in idle.items()},
        "call_idle_ms": 1e3 * call_idle,
        "idle_owned": (100.0 * sum(idle[k] for k in spans.RUNNER)
                       / call_idle if call_idle > 0 else None),
        "captured_s": wall, "uncaptured_s": wall_eager,
        "uncaptured_eager_ticks": eager_ticks,
        "lost_launches": lost,
        "peak_reserved_gb": {"before_uncaptured": peak_captured / 1e9,
                             "after": torch.cuda.max_memory_reserved() / 1e9}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
