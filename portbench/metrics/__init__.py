"""One reader a per-layer metric (`<metric>.py`): ``read(run)`` takes the
traced run's records and returns the metric, or None where it finds
nothing to read. ``run`` holds ``record`` (`harness.trace.Record`: the
device operations by name, their intervals, the host operations),
``ticks``, ``calls`` and ``gradients`` traced, ``wall_s`` (the traced
calls' host-clock seconds), ``gradient_flops`` (one client gradient's
operations, `harness.flops`) and ``quant`` (the quant kernels timed
alone: (kernel, numel, ms, bound ms) a leaf)."""
