"""The readings a cell's limits are set from, on the card:

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3 \
        [--control 3] [--faults 3]

For each seed, the port set up as a run sets it up, its warm-up call and
one more call (the window's call), against the plain reference (the
lower readings); for the first `--control` seeds, the reference in TF32 in
the port's place (the control: the upper readings); for the first
`--faults` seeds, the port with a fault planted in its timed path (a rule
that keeps its state, half of each batch, every gradient scaled by 1.001). One
JSON line a reading on standard output. The benchmark's own runs never
run this.
"""
import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def faults(port):
    """name -> (plant, undo): faults planted in the port's timed path."""
    import torch
    from harness.tasks import lm
    from repro_torch.convert import tree_map
    ace = port.core.ACEIncremental
    real_step, real_build = ace.step, lm.build

    def keep_state(self, state, arr):
        return state, state["u"], torch.ones((), dtype=torch.bool,
                                             device=state["u"]["final_norm"]
                                             .device), 1.0

    def wrap(alter):
        def build(*a, **kw):
            task = real_build(*a, **kw)
            task.grad_fn.fn = alter(task.grad_fn.fn)
            return task
        return build

    def half(fn):
        def g(w, clients, noise):
            h = noise.shape[-1] // 2
            return fn(w, clients, torch.cat([noise[..., :h]] * 2, -1))
        return g

    def altered(fn):
        def g(w, clients, noise):
            loss, grads = fn(w, clients, noise)
            return loss, tree_map(lambda v: v * 1.001, grads)
        return g

    def restore():
        ace.step, lm.build = real_step, real_build
    return {"state_unchanged": (lambda: setattr(ace, "step", keep_state),
                                restore),
            "half_batch": (lambda: setattr(lm, "build", wrap(half)), restore),
            "answer_altered": (lambda: setattr(lm, "build", wrap(altered)),
                               restore)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--faults", type=int, default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(HERE))
    import torch
    import reference
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    from harness import cell, check
    from harness import port as port_mod
    from harness.inputs import make_weights
    spec = cell.load_spec(args.workload, ROOT)
    port = port_mod.load(ROOT)
    port.build.build()
    shapes = reference.shapes(spec.cfg)
    planted = faults(port)

    def program(seed):
        prog = cell.Program(port, spec, seed, "cuda")
        warm = prog.call()
        del warm
        out = prog.call()
        torch.cuda.synchronize()
        rule = prog.rule
        prog.runner = prog.task = None
        cell.free()
        w0 = make_weights(shapes, spec.cfg["init"], seed, "cuda")
        s = cell.summary(rule, out, w0)
        del out, w0
        cell.free()
        return s

    def emit(kind, seed, side, ref, t):
        print(json.dumps({"workload": args.workload, "kind": kind,
                          "seed": seed, "seconds": time.perf_counter() - t,
                          **check.compare(side, ref),
                          "worst": check.worst_leaves(side, ref)}),
              flush=True)

    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        ref = check.reference_summary(spec.cfg, spec.mix, seed, "cuda")
        emit("program", seed, program(seed), ref, t)
        if i < args.control:
            t = time.perf_counter()
            ctl = check.reference_summary(spec.cfg, spec.mix, seed, "cuda",
                                          "tf32")
            emit("control_tf32", seed, ctl, ref, t)
        if i < args.faults:
            for name, (plant, undo) in planted.items():
                t = time.perf_counter()
                plant()
                try:
                    emit(f"fault_{name}", seed, program(seed), ref, t)
                finally:
                    undo()
        del ref
        cell.free()
    return 0


if __name__ == "__main__":
    sys.exit(main())
