#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises, and the script exits non-zero without a
result line):
  1. the card's name and power limit, from nvidia-smi;
  2. build the hand-written kernels from src/repro_torch/kernels/csrc with
     nvcc for sm_90a (one process per source, all at once);
  3. each kernel against its plain PyTorch version on the card, at the
     slice's shapes (d = 17,226, K = 16, R = 1, 2, 3) and at
     d = 2^24 + 3: int8 rows bit-identical, f32 outputs within 1e-6 of the
     output's scale; commit_batch with int8 and with f32 cache rows (the
     two row types the main path runs), with NaN-poisoned invalid lanes and
     an all-invalid batch, its rows bit-identical; each kernel timed beside its byte bound and the plain
     version (no single PyTorch call computes any of these fused
     functions, so there is no library yardstick);
  4. the main path: `run_staleness_scan` on the vision task at full width
     (n = 100 clients, d = 17,226) for ACE, ACED and CA²FL — int8 cache at
     K = 1 and K = 16, f32 cache at K = 16 — with the launch counts zeroed
     just before and read just after; each rule's kernel must have been
     launched, the final model finite and its test accuracy above chance;
     the int8 K = 16 ACE run is repeated through the plain versions on the
     card and must end within 1e-4 of the kernels' run;
  5. one JSON line of per-kernel numbers, then the result line.

Needs one GPU; imports nothing of JAX.
"""
from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
F32_OPS_PER_S = 67e12            # f32 outside the tensor cores
F32_TOL = 1e-6
D_SLICE, K_SLICE, D_LARGE = 17226, 16, (1 << 24) + 3

KERNELS = {
    # name: (source, TPU kernel it replaces)
    "row_delta": ("src/repro_torch/kernels/csrc/row_delta.cu",
                  "src/repro/kernels/row_delta.py:66"),
    "cache_row_update": ("src/repro_torch/kernels/csrc/cache_update.cu",
                         "src/repro/kernels/cache_update.py:67"),
    "commit_batch": ("src/repro_torch/kernels/csrc/commit_batch.cu",
                     "src/repro/kernels/commit_batch.py:116"),
}
RULE_LANES = {1: (), 2: ("a", "b"), 3: ("a", "g")}   # ACE, ACED, CA²FL


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


# --- timing -----------------------------------------------------------------

def _device_us(torch, prof, name_part):
    """Device time (µs) in a profile: of the kernels whose name holds
    `name_part`, or of every kernel when it is None. Only the device-side
    events count (a CPU op's own device time is its kernels' again)."""
    total = 0.0
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        if name_part is None or name_part in e.key:
            total += e.self_device_time_total
    return total


def measure(torch, fn, iters, kernel_name=None):
    """(device ms per call, event ms per call). Device time comes from
    torch.profiler's CUDA trace: the named kernel's own time, or all the
    call's kernels for the plain version; None when the profiler saw no
    device time. Event time is CUDA events around `iters` back-to-back
    calls (what a caller pays, host overhead included)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    event_ms = start.elapsed_time(end) / iters
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    dev_us = _device_us(torch, prof, kernel_name)
    return (dev_us / 1e3 / iters if dev_us > 0 else None), event_ms


# --- phase 3: kernels against their plain versions -----------------------------

def row_inputs(torch, d, dev, seed):
    from repro_torch.kernels import ref
    g = torch.Generator(device=dev).manual_seed(seed)
    u = torch.randn(d, generator=g, device=dev)
    x = torch.randn(d, generator=g, device=dev) * 5
    q, s = ref.quantize_rows_ref(torch.randn(1, d, generator=g, device=dev))
    return u, x, q[0], s[0], ref.row_scale(x)


def commit_inputs(torch, K, d, R, lanes, dev, seed, valid=None,
                  rows="int8"):
    """The aggregators' calling convention: lane weights zero on invalid
    lanes; for int8 rows, `new_s` from the sanitized payloads, for f32 rows
    no scales. The invalid lanes' payloads are NaN-poisoned."""
    from repro_torch.kernels import ref
    g = torch.Generator(device=dev).manual_seed(seed)
    G = torch.randn(K, d, generator=g, device=dev) * 3
    if valid is None:
        valid = torch.rand(K, generator=g, device=dev) < 0.75
        valid[0] = True
    G[~valid] = float("nan")
    old = torch.randn(K, d, generator=g, device=dev)
    if rows == "int8":
        q, s = ref.quantize_rows_ref(old)
        new_s = ref.row_scale(torch.where(valid[:, None], G, 0.0))
    else:
        q, s, new_s = old, None, None
    kw = dict(G=G, old_rows=q, old_s=s, new_s=new_s, valid=valid, vecs=torch.randn(R, d, generator=g, device=dev),
              coef=torch.randn(R, R + 4, generator=g, device=dev),
              upd_w=torch.randn(R + 4, generator=g, device=dev))
    for name in lanes:
        kw[f"lane_{name}"] = torch.rand(K, generator=g, device=dev) * valid
    return kw


def _err(torch, a, b):
    """(max abs error, max abs error relative to the reference's scale)."""
    err = float((a.double() - b.double()).abs().max())
    return err, err / max(1.0, float(b.double().abs().max()))


def compare_rows(torch, ops, name, d, dev, card):
    """row_delta / cache_row_update against their plain versions at d.
    Returns (max abs f32 error, timing row)."""
    u, g, c, o, s = row_inputs(torch, d, dev, seed=d % 1000)
    inv_n = torch.full((), 0.01, device=dev)
    if name == "row_delta":
        call = lambda backend=None: ops.row_delta(g, c, o, s, backend=backend)
        nbytes, nops = 10 * d, 7 * d
    else:
        call = lambda backend=None: ops.cache_row_update(
            u, g, c, o, s, inv_n, backend=backend)
        nbytes, nops = 14 * d, 9 * d
    f1, q1 = call()
    f2, q2 = call("torch")
    torch.cuda.synchronize()
    check(torch.equal(q1, q2), f"{name} d={d}: int8 row differs from plain")
    err, rel = _err(torch, f1, f2)
    check(rel <= F32_TOL, f"{name} d={d}: f32 error {err} > tolerance")
    iters = 200 if d < 1e6 else 20
    kern = "row_delta_kernel" if name == "row_delta" else "cache_update_kernel"
    ms, ev = measure(torch, call, iters, kern)
    plain_ms, plain_ev = measure(torch, lambda: call("torch"), iters)
    bound = max(nbytes / HBM_BYTES_PER_S, nops / F32_OPS_PER_S) * 1e3
    print(f"kernel {name} d={d}: int8 identical, max_abs_err {err:.3e} "
          f"(tolerance {F32_TOL:g} of the output's scale); "
          f"kernel {_fmt(ms)} ms device ({ev:.5f} ms per call), plain "
          f"{_fmt(plain_ms)} ms device ({plain_ev:.5f} ms per call), bound "
          f"{bound:.6f} ms (bytes) [{card}]")
    return err, dict(ms=ms if ms is not None else ev,
                     plain_ms=plain_ms if plain_ms is not None else plain_ev,
                     bound_ms=bound, bound_by="bytes")


def compare_commit(torch, ops, K, d, R, dev, card, valid=None, label="",
                   rows="int8"):
    lanes = RULE_LANES[R]
    kw = commit_inputs(torch, K, d, R, lanes, dev, seed=K + R + d % 997,
                       valid=valid, rows=rows)
    r1, v1, u1 = ops.commit_batch(**kw)
    r2, v2, u2 = ops.commit_batch(**kw, backend="torch")
    torch.cuda.synchronize()
    tag = f"commit_batch {rows} K={K} d={d} R={R}{label}"
    check(torch.equal(r1, r2), f"{tag}: {rows} rows differ from plain")
    inv = ~kw["valid"]
    check(torch.equal(r1[inv], kw["old_rows"][inv]),
          f"{tag}: an invalid lane's row changed")
    check(bool(torch.isfinite(v1).all() and torch.isfinite(u1).all()),
          f"{tag}: non-finite output")
    ev_, rv = _err(torch, v1, v2)
    eu, ru = _err(torch, u1, u2)
    check(max(rv, ru) <= F32_TOL, f"{tag}: f32 error {max(ev_, eu)}")
    err = max(ev_, eu)
    iters = 200 if d < 1e6 else 10
    ms, evt = measure(torch, lambda: ops.commit_batch(**kw), iters,
                      "commit_batch_kernel")
    plain_ms, plain_ev = measure(
        torch, lambda: ops.commit_batch(**kw, backend="torch"), iters)
    n_l = len(lanes)
    row_b = kw["old_rows"].element_size()
    nbytes = d * (K * (4 + 2 * row_b) + 2 * R * 4 + 4) + 4 * (
        6 * K + (R + 1) * (R + 4))
    per_lane = 8 if rows == "int8" else 2    # dequant, quant, delta / delta
    nops = d * (K * (per_lane + 2 * n_l) + 2 * (R + 1) * (R + 1 + n_l))
    bound = max(nbytes / HBM_BYTES_PER_S, nops / F32_OPS_PER_S) * 1e3
    by = "bytes" if nbytes / HBM_BYTES_PER_S >= nops / F32_OPS_PER_S \
        else "operations"
    print(f"kernel {tag}: {rows} rows identical, max_abs_err {err:.3e} (tolerance "
          f"{F32_TOL:g} of the output's scale); kernel "
          f"{_fmt(ms)} ms device ({evt:.5f} ms per call), plain "
          f"{_fmt(plain_ms)} ms device ({plain_ev:.5f} ms per call), bound "
          f"{bound:.6f} ms ({by}) [{card}]")
    return err, dict(ms=ms if ms is not None else evt,
                     plain_ms=plain_ms if plain_ms is not None else plain_ev,
                     bound_ms=bound, bound_by=by)


def _fmt(x):
    return "n/a" if x is None else f"{x:.5f}"


# --- phase 4: the main path -----------------------------------------------------

def engine_runs():
    """(rule, cache dtype, K, T, n_events, kernel) of the main path. ACE and
    ACED emit every tick; CA²FL (buffer 10) every 10th arrival at K = 1 and
    every tick at K = 16."""
    runs = []
    for dtype, K in (("int8", 1), ("int8", K_SLICE), ("float32", K_SLICE)):
        for rule in ("ace", "aced", "ca2fl"):
            if K == 1:
                kernel = "cache_row_update" if rule == "ace" else "row_delta"
                T, E = (30, 300) if rule == "ca2fl" else (300, 299)
            else:
                kernel = "commit_batch"
                T, E = (300, 300) if rule == "ca2fl" else (300, 299)
            runs.append((rule, dtype, K, T, E, kernel))
    return runs


def make_rule(rule, dtype, K, backend=None):
    from repro_torch.core import ACED, CA2FL, ACEIncremental
    if rule == "ace":
        return ACEIncremental(cache_dtype=dtype, backend=backend)
    if rule == "aced":
        return ACED(tau_algo=10, cache_dtype=dtype, max_cohort=K,
                    backend=backend)
    return CA2FL(buffer_size=10, cache_dtype=dtype, backend=backend)


def run_engine(task, rule, dtype, K, T, E, dev, backend=None, seed=0):
    import numpy as np
    import torch
    from repro_torch.core import run_staleness_scan
    lr = 0.2 * float(np.sqrt(task.n_clients / T))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = run_staleness_scan(
        grad_fn=task.grad_fn, params0=task.params0,
        aggregator=make_rule(rule, dtype, K, backend),
        n_clients=task.n_clients, server_lr=lr, T=T, beta=5.0, k_batch=K,
        n_events=E, seed=seed, device=dev)
    wall = time.perf_counter() - t0
    return res, wall


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.convert import unravel
    from repro_torch.core import make_vision_task
    from repro_torch.kernels import build, ops

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    dev = torch.device("cuda")
    print(f"torch {torch.__version__} cuda {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")

    # 2. build
    t0 = time.perf_counter()
    build.build()
    print(f"build: {len(build.KERNELS)} kernels with nvcc for sm_90a in "
          f"{time.perf_counter() - t0:.1f} s")
    for name in build.KERNELS:
        report = build.ptxas_report(name)
        regs = [int(w) for w in re.findall(r"Used (\d+) registers", report)]
        spills = sum(int(w) for w in re.findall(r"(\d+) bytes spill", report))
        check(regs, f"{name}: no ptxas report")
        print(f"ptxas {name}: {len(regs)} kernel(s), {min(regs)}-{max(regs)} "
              f"registers, {spills} bytes spilled")

    # 3. each kernel against its plain version, on the card
    errs, rows = {}, {}
    for name in ("row_delta", "cache_row_update"):
        errs[name], rows[name] = compare_rows(torch, ops, name, D_SLICE, dev,
                                              card)
        e_big, _ = compare_rows(torch, ops, name, D_LARGE, dev, card)
        errs[name] = max(errs[name], e_big)
    # both row types of the main path: the int8 cache and the f32 cache
    errs["commit_batch"] = 0.0
    none = torch.zeros(K_SLICE, dtype=torch.bool, device=dev)
    for row_type in ("int8", "float32"):
        for R in (1, 2, 3):
            e, row = compare_commit(torch, ops, K_SLICE, D_SLICE, R, dev,
                                    card, rows=row_type)
            errs["commit_batch"] = max(errs["commit_batch"], e)
            if (row_type, R) == ("int8", 3):
                rows["commit_batch"] = row
        e, _ = compare_commit(torch, ops, K_SLICE, D_LARGE, 3, dev, card,
                              rows=row_type)
        errs["commit_batch"] = max(errs["commit_batch"], e)
        e, _ = compare_commit(torch, ops, K_SLICE, D_SLICE, 2, dev, card,
                              valid=none, label=" all-invalid", rows=row_type)
        errs["commit_batch"] = max(errs["commit_batch"], e)
    print("library yardstick: none — no single PyTorch call computes "
          "row_delta, cache_row_update or commit_batch (library_ms null)")

    # 4. the main path, at full width
    task = make_vision_task(device=dev)
    d = sum(p.numel() for layer in task.params0 for p in layer.values())
    check(d == D_SLICE, f"vision task has d={d}, expected {D_SLICE}")
    print(f"engine: vision task, n={task.n_clients} clients, d={d}, "
          f"batch 50 [{card}]")
    totals = dict.fromkeys(KERNELS, 0)
    ace_int8_k = wall_ace_k = None
    for rule, dtype, K, T, E, kernel in engine_runs():
        ops.reset_launch_counts()
        res, wall = run_engine(task, rule, dtype, K, T, E, dev)
        counts = ops.launch_counts()
        for k, v in counts.items():
            totals[k] += v
        check(counts[kernel] > 0, f"{rule} {dtype} K={K}: {kernel} was not "
              "launched")
        check(bool(torch.isfinite(torch.as_tensor(res.w)).all()),
              f"{rule} {dtype} K={K}: non-finite model")
        acc = task.eval_fn(unravel(torch.as_tensor(res.w, device=dev),
                                   task.params0))["accuracy"]
        check(acc > 0.5, f"{rule} {dtype} K={K}: accuracy {acc}, not well above "
              "chance (0.1)")
        print(f"engine {rule} {dtype} K={K}: T={T}, {E} ticks, "
              f"{len(res.ts)} updates, accuracy {acc:.4f}, {wall:.2f} s, "
              f"{E / wall:.1f} ticks/s, {E * K / wall:.1f} arrivals/s, "
              f"launches {counts} [{card}]")
        if (rule, dtype, K) == ("ace", "int8", K_SLICE):
            ace_int8_k, wall_ace_k = res, wall
    ops.reset_launch_counts()
    res, wall = run_engine(task, "ace", "int8", K_SLICE, 300, 299, dev,
                           backend="torch")
    check(sum(ops.launch_counts().values()) == 0,
          "backend='torch' launched a kernel")
    dev_w = float(abs(res.w - ace_int8_k.w).max()
                  / max(1e-12, abs(ace_int8_k.w).max()))
    check(dev_w <= 1e-4, f"ace int8 K=16: plain run deviates {dev_w}")
    print(f"engine ace int8 K={K_SLICE} plain versions: {wall:.2f} s, "
          f"{299 * K_SLICE / wall:.1f} arrivals/s, final w within "
          f"{dev_w:.3e} (relative) of the kernels' run [{card}]")

    # where a tick's time goes: device time of one traced run against the
    # untraced run's wall clock (the trace itself slows the host)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        run_engine(task, "ace", "int8", K_SLICE, 300, 299, dev)
    busy_ms = _device_us(torch, prof, None) / 1e3 / 299
    tick_ms = 1e3 * wall_ace_k / 299
    print(f"engine ace int8 K={K_SLICE}: device busy {busy_ms:.4f} ms per "
          f"tick of {tick_ms:.4f} ms wall, idle share "
          f"{1 - busy_ms / tick_ms:.3f} [{card}]")
    top = sorted((e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA),
                 key=lambda e: -e.self_device_time_total)[:6]
    for e in top:
        print(f"  {e.self_device_time_total / 1e3 / 299:.4f} ms/tick "
              f"{e.count / 299:.1f} launches/tick  {e.key[:90]}")

    # 5. results
    report = []
    for name, (source, replaces) in KERNELS.items():
        check(totals[name] > 0, f"{name} never launched on the main path")
        report.append({"name": name, "route": "cuda", "source": source,
                       "replaces": replaces, "launches": totals[name],
                       "max_abs_err": errs[name], **rows[name],
                       "library_ms": None})
    print(json.dumps({"kernels": report}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
