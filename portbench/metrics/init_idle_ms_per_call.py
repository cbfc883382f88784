"""Device idle ms a call inside the program's ``runner.init`` span (the
init's eager gradients, the cache fill, the ring's reset: the eager part
of a captured call): the part of the span's host range in which no device
operation ran, over the calls traced. None where the trace has no such
span. Logs the init's idle by its children (``init.payload``,
``init.rule_state``, ``init.ring``), the runtime calls that held the host
longest inside the init, and the share of the call's idle that lies
inside ``runner.feed``, ``runner.init`` or ``runner.ticks``.

One traced call cannot resolve a change here: the idle is the host's
waits in the eager init, and it spread 71-674 ms a call over traced runs
of one tree. ``init_busy_ms_per_call`` is the init's stable part."""
import sys

from harness.spans import INIT_CHILDREN, RUNNER, idle_inside, runtime_inside
from harness.trace import busy_seconds


def read(run):
    rec = run.record
    if not run.calls or not any(h[2] == "runner.init" for h in rec.host):
        return None
    idle = idle_inside(rec, RUNNER + INIT_CHILDREN)
    per_call = {k: 1e3 * v / run.calls for k, v in idle.items()}
    rest = per_call["runner.init"] - sum(per_call[k] for k in INIT_CHILDREN)
    call_idle = 1e3 * (run.wall_s - busy_seconds(rec.intervals)) / run.calls
    owned = sum(per_call[k] for k in RUNNER)
    print("init_idle_ms_per_call: the init's idle by span (ms a call) "
          + ", ".join(f"{k} {per_call[k]:.3f}" for k in INIT_CHILDREN)
          + f", the rest of runner.init {rest:.3f}; its longest runtime "
          + "calls " + ", ".join(f"{k} {1e3 * v / run.calls:.3f}" for k, v
                                in runtime_inside(rec, "runner.init"))
          + "; the call's idle "
          + ", ".join(f"{k} {per_call[k]:.3f}" for k in RUNNER)
          + f" of {call_idle:.3f} ms a call"
          + (f" ({100 * owned / call_idle:.2f} % inside them)"
             if call_idle > 0 else ""), file=sys.stderr, flush=True)
    return per_call["runner.init"]
