"""Device busy ms a call inside the program's ``runner.init`` span: the
part of the span's host range in which some device operation ran, over
the calls traced. None where the trace has no such span. The init's work
on the device (the n clients' first gradients, the cache fill, the
ring's reset), which `init_idle_ms_per_call`'s host waits leave alone.
Logs the span's host ms a call beside it."""
import sys

from harness.spans import busy_inside


def read(run):
    rec = run.record
    if not run.calls or not any(h[2] == "runner.init" for h in rec.host):
        return None
    host, busy = busy_inside(rec, ("runner.init",))["runner.init"]
    print(f"init_busy_ms_per_call: runner.init {host / 1e6 / run.calls:.3f} "
          f"host ms a call, {busy / 1e6 / run.calls:.3f} of them busy",
          file=sys.stderr, flush=True)
    return busy / 1e6 / run.calls
