"""Share (%) of the H100's f32 peak outside the tensor cores (67 TFLOP/s)
that the traced calls reached: every client gradient they computed (the
inits' and the ticks'), 3 x the analytic forward count each, over the
calls' host-clock seconds."""
from harness.flops import F32_FLOPS


def read(run):
    if not run.gradients or run.wall_s <= 0:
        return None
    return 100.0 * run.gradients * run.gradient_flops / run.wall_s / F32_FLOPS
