"""One run of one cell: set-up, the measured window, the traced window, the
check against the reference, and the result line.

Set-up builds the port's kernels (timed apart as ``build_s``), the task
over the benchmark's weights, the streams and the runner, then makes one
whole warm-up call, which captures the tick as a CUDA graph; that runner
serves the window. The window calls it back to back, one whole run of the
mix's events from w0 a call (its init included), until `seconds` have
passed; the call in progress then ends it. Each call's results are freed
before the next starts, but the last call's, which the check compares.
"""
from __future__ import annotations

import gc
import importlib
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace
from typing import Dict

import torch

import reference
from harness import check, flops, trace
from harness.inputs import QUANT, Streams, generator, lr_of, make_weights
from harness.tree import paths

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_spec(workload: str, root: Path) -> SimpleNamespace:
    """The cell `workload` of ``<root>/BENCHMARK.json``: its configuration
    file, its mix (``portbench/mixes/<traffic>.json``), the limits of its
    check (``portbench/limits/<workload>.json``, none before they are
    set) and the per-layer metrics it reports."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cell = next((w for w in bench["workloads"] if w["name"] == workload),
                None)
    if cell is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    cfg = json.loads((root / entry["file"]).read_text())
    mix = json.loads((root / "portbench" / "mixes"
                      / f"{cell['traffic']}.json").read_text())
    limits_file = root / "portbench" / "limits" / f"{workload}.json"
    limits = (json.loads(limits_file.read_text())["limits"]
              if limits_file.exists() else {})

    def reported(m):
        return m.get("workloads") is None or workload in m["workloads"]
    return SimpleNamespace(
        name=workload, cell=cell, cfg=cfg, mix=mix, limits=limits,
        end_to_end=[m for m in bench["end_to_end"] if reported(m)],
        per_layer=[m for m in bench["per_layer"] if reported(m)])


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def free():
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


class Program:
    """The port set up for one cell and seed: its task over the
    benchmark's weights, the streams, and the runner."""

    def __init__(self, port, spec, seed: int, device):
        cfg, mix = spec.cfg, spec.mix
        shapes = reference.shapes(cfg)
        want = cfg.get("expect")
        got = {"leaves": len(shapes),
               "numel": sum(math.prod(s) for s in shapes.values())}
        if want is not None and got != want:
            raise RuntimeError(f"{cfg['name']}: {got}, the file expects "
                               f"{want}")
        weights = make_weights(shapes, cfg["init"], seed, device)
        self.task_mod = importlib.import_module(f"harness.tasks.{mix['task']}")
        self.task = self.task_mod.build(port, cfg, mix, seed, weights, device)
        del weights
        n, K = mix["n_clients"], mix["k_batch"]
        E = mix["events_per_call"]
        s = Streams(seed, E, n, K, mix["beta"], mix["batch"], device)
        never = torch.full((n,), port.sim.NEVER, dtype=torch.int32,
                           device=device)
        self.rand = port.scan.StalenessRandomness(s.gumbels, s.tau_raw,
                                                  never, never.clone())
        self.noise = port.engine.PayloadNoise(s.noise_init, s.noise_ticks)
        self.rule = importlib.import_module(f"harness.rules.{mix['rule']}")
        self.runner = port.core.make_staleness_runner(
            grad_fn=self.task.grad_fn, params0=self.task.params0,
            aggregator=self.rule.build(port.core, mix), n_clients=n,
            T=mix["T"], beta=mix["beta"], tau_max=mix["tau_max"],
            k_batch=K, layout=mix["layout"],
            history_dtype=mix["history_dtype"], device=device)
        self.lr = lr_of(mix)
        self.events, self.k = E, K

    def call(self):
        return self.runner(self.rand, self.noise, self.lr)

    def leaves(self):
        return paths(self.task.params0)


def summary(rule, out, w0) -> Dict:
    """What the check compares of a call's result `out` (the runner's
    (w, state, outs, extras)), moved to the host as numbers."""
    w, state, outs, _ = out
    wp = paths(w)
    return {"losses": [float(x) for x in outs["loss"].float().cpu()],
            "unorms": [float(x) for x in outs["unorm"].float().cpu()],
            "change": {k: check.norm(wp[k] - w0[k]) for k in wp},
            "update": {k: check.norm(v) for k, v in rule.update(state).items()},
            "cache": rule.cache_norms(state)}


def nonfinite(out) -> int:
    return int((~torch.isfinite(out[2]["loss"])).sum())


class Clocks:
    """nvidia-smi sampling the card's clocks and power beside the window
    (none off the card or where the tool is missing); `stop` ends the
    sampler and returns its line (None where nothing was sampled)."""
    QUERY = "name,clocks.sm,power.draw,power.limit,temperature.gpu"

    def __init__(self, device):
        self.proc = None
        if torch.device(device).type != "cuda":
            return
        try:
            self.proc = subprocess.Popen(
                ["nvidia-smi", f"--query-gpu={self.QUERY}",
                 "--format=csv,noheader,nounits", "-lms", "2000",
                 "-i", str(torch.cuda.current_device())],
                stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        except OSError:
            self.proc = None

    def stop(self) -> str:
        if self.proc is None:
            return None
        self.proc.terminate()
        text, _ = self.proc.communicate()
        rows = [r.split(", ") for r in text.strip().splitlines()
                if r.count(",") == 4]
        if not rows:
            return "nvidia-smi: no sample"

        def col(i):
            vals = []
            for r in rows:
                try:
                    vals.append(float(r[i]))
                except ValueError:
                    pass
            if not vals:
                return "n/a"
            return (f"{min(vals):g}/{statistics.median(vals):g}/"
                    f"{max(vals):g}")
        return (f"card {rows[0][0]}, power limit {rows[0][3]} W; "
                f"{len(rows)} samples (min/median/max): sm clock {col(1)} "
                f"MHz, power {col(2)} W, temperature {col(4)} C")


def window(program, seconds: float, device):
    """Calls back to back until `seconds` have passed -> (completed
    calls, window seconds, the last call's result, non-finite losses)."""
    calls, bad, out = 0, 0, None
    sync(device)
    t0 = time.perf_counter()
    while True:
        out = program.call()
        sync(device)
        calls += 1
        bad += nonfinite(out)
        if time.perf_counter() - t0 >= seconds:
            return calls, time.perf_counter() - t0, out, bad
        del out
        out = None


def quant_times(port, sizes, seed: int, device, log):
    """quantize_rows and dequantize_rows alone at one row of each leaf size
    (CUDA events, warm) -> [(kernel, numel, ms, bound ms)]; [] off the
    card."""
    if torch.device(device).type != "cuda":
        return []
    g = generator(seed, QUANT, device)
    out = []
    for numel in sorted(set(sizes)):
        x = torch.randn((1, numel), generator=g, device=device)
        iters = max(3, min(100, int(2e8 // numel)))
        for kernel, fn, nbytes in (
                ("quantize_rows", lambda: port.ops.quantize_rows(x),
                 flops.quant_bytes(numel)),
                ("dequantize_rows", None, flops.dequant_bytes(numel))):
            if fn is None:
                q, s = port.ops.quantize_rows(x)
                fn = (lambda q=q, s=s: port.ops.dequantize_rows(q, s))
            fn()
            torch.cuda.synchronize()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(iters):
                fn()
            b.record()
            torch.cuda.synchronize()
            ms = a.elapsed_time(b) / iters
            bound = 1e3 * nbytes / flops.HBM_BYTES_PER_S
            out.extend([(kernel, numel, ms, bound)] * sizes.count(numel))
        del x
    log(f"quant kernels timed alone at {len(set(sizes))} leaf sizes")
    return out


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def run(workload: str, seed: int, seconds: float, traced: bool, *,
        root: Path, t_start: float, device="cuda", log=None) -> Dict:
    """One run -> the result dict (the result line's keys, ``checks``
    last); `t_start` is the process's start on the host clock."""
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    from harness import port as port_mod
    spec = load_spec(workload, root)
    port = port_mod.load(root)
    cuda = torch.device(device).type == "cuda"
    build_s = 0.0
    if cuda:
        t = time.perf_counter()
        port.build.build()
        build_s = time.perf_counter() - t
        torch.cuda.reset_peak_memory_stats()
    program = Program(port, spec, seed, device)
    log(f"{workload}: task, streams and runner built; warm-up call")
    warm = program.call()
    sync(device)
    bad_warm = nonfinite(warm)
    del warm
    setup_s = time.perf_counter() - t_start
    log(f"set-up {setup_s:.3f} s (kernel build {build_s:.3f} s)")

    clocks = Clocks(device)
    rec = None
    if traced:
        rec, out = trace.traced_call(program.call, port.ops.reset_launch_counts,
                                     port.ops.launch_counts, log)
        calls, wall = 1, rec.wall_s
        bad = nonfinite(out)
    else:
        calls, wall, out, bad = window(program, seconds, device)
    card = clocks.stop()
    if card:
        print(card, flush=True)
    peak = torch.cuda.max_memory_reserved() if cuda else 0
    E, K, n = program.events, program.k, spec.mix["n_clients"]
    arrivals = K * E * calls

    sizes = [x.numel() for x in program.leaves().values()]
    rule = program.rule
    state_out = out
    del out
    # the program's state goes before the reference runs: the weights are
    # made again from the seed to measure the program's change
    program.runner = program.task = None
    free()
    w0 = make_weights(reference.shapes(spec.cfg), spec.cfg["init"], seed,
                      device)
    prog = summary(rule, state_out, w0)
    del state_out, w0
    free()
    qt = quant_times(port, sizes, seed, device, log) if traced else []

    t = time.perf_counter()
    ref = check.reference_summary(spec.cfg, spec.mix, seed, device)
    numbers = check.compare(prog, ref)
    log(f"reference run and comparison {time.perf_counter() - t:.3f} s; "
        f"every reading {json.dumps(numbers)}; worst leaves "
        f"{json.dumps(check.worst_leaves(prog, ref))}; leaves left out "
        f"{sorted(set(ref['change']) - ref['moving'])}")
    correct = check.verdict(numbers, spec.limits) and bad == 0 \
        and bad_warm == 0

    result = {"correct": correct, "attempted": arrivals, "failed": bad}
    if traced:
        grads = calls * (n + E * K)
        rec_ns = SimpleNamespace(
            record=rec, ticks=calls * E, calls=calls, wall_s=wall,
            gradients=grads,
            gradient_flops=program.task_mod.gradient_flops(spec.cfg,
                                                           spec.mix),
            quant=qt)
        metrics = {}
        for m in spec.per_layer:
            reader = importlib.import_module(f"metrics.{m['name']}")
            value = reader.read(rec_ns)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        busy = trace.busy_seconds(rec.intervals)
        device_info = {"busy_s": busy, "window_s": wall}
        breakdown = {"device_ops": trace.top_ops(rec),
                     "idle_gaps": trace.idle_gaps(rec)}
    else:
        values = {"arrivals_per_s": arrivals / wall, "setup_s": setup_s,
                  "peak_mem_gb": peak / 1e9}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in spec.end_to_end}
        device_info, breakdown = {}, None
    result["metrics"] = metrics
    result["device"] = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name() if cuda else "cpu",
        "count": 1, "memory_peak_bytes": int(peak), **device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["build_s"] = build_s
    result["calls"] = calls
    result["checks"] = {k: {"value": numbers[k], "limit": spec.limits.get(k)}
                        for k in (spec.limits or numbers)}
    return result
