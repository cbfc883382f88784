#!/usr/bin/env python3
"""Time designs of the `commit_batch` kernel, and the int8 ACE engine, on one
NVIDIA GPU, each in its own process within one run.

    python3 tools/commit_batch_designs.py kernels
    python3 tools/commit_batch_designs.py engine TREE [TREE ...]

`kernels` copies `src/repro_torch` once per design into the gitignored
`build/designs/<design>/`, with its own `kernels/csrc/commit_batch.cu`:

  final            the repo's kernel;
  one_thread       the repo's kernel with one thread per feature at every d
                   (no int8 lane split);
  lane_parallel_N  `tools/commit_batch_lane_parallel.cu`: a tile of 128
                   features and 16 lanes a block, a warp per lane row and 4
                   features a thread in one vector load (a scalar head and
                   tail on misaligned rows), the terms summed out of shared
                   memory after a barrier; N lane rows a thread (N = 1: 512
                   threads a block, one lane row each);
  lane_parallel_4_div  lane_parallel_4 dividing every element (no multiply
                   by 1/new_s).

It builds them all at once (one nvcc each, into each copy's own `build/`),
then times each in its own process, in that order and `final` once more at
the end: per design and shape, the kernel's device time from torch.profiler
(CUDA-event time where the trace lost the kernel), the byte bound and
whether the outputs are bit-identical to the plain version.

`engine` runs `run_staleness_scan` (ACE, int8 cache, K = 16, the vision
task at full width, 300 ticks) three times in each TREE — a directory
holding `src/repro_torch`, e.g. a `git archive` of another commit unpacked
under `build/` — one process per tree, in the order given, and prints
arrivals/s per run (the first run of a process includes its warm-up).

Every line carries the card's name and power limit from nvidia-smi.
"""
from __future__ import annotations

import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
DESIGNS = ROOT / "build" / "designs"
LANE_PARALLEL = Path(__file__).resolve().parent / "commit_batch_lane_parallel.cu"
# (design, source, [(text, replacement)]) — each text must occur in the source
VARIANTS = (
    ("final", None, ()),
    ("one_thread", None, (("return d < 8LL * 32 * sms;", "return false;"),)),
    ("lane_parallel_1", LANE_PARALLEL,
     (("constexpr int kPerThread = 4;", "constexpr int kPerThread = 1;"),)),
    ("lane_parallel_2", LANE_PARALLEL,
     (("constexpr int kPerThread = 4;", "constexpr int kPerThread = 2;"),)),
    ("lane_parallel_4", LANE_PARALLEL, ()),
    ("lane_parallel_4_div", LANE_PARALLEL,
     (("if (!repro::quant_fast(g, inv, q)) q = repro::quant(g, ns);",
       "q = repro::quant(g, ns);"),)),
)
# (rows, K, d, R): the main path's shape, R = 1 there, and the large width
SHAPES = tuple((rows, 16, d, R) for rows in ("int8", "float32")
               for d, R in ((17226, 3), (17226, 1), ((1 << 24) + 3, 3)))


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def make_tree(name, source, subs) -> Path:
    tree = DESIGNS / name
    shutil.rmtree(tree, ignore_errors=True)
    shutil.copytree(ROOT / "src" / "repro_torch", tree / "src" / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    cu = tree / "src" / "repro_torch" / "kernels" / "csrc" / "commit_batch.cu"
    text = (source or cu).read_text()
    for old, new in subs:
        if old not in text:
            raise SystemExit(f"{name}: {old!r} not in the source")
        text = text.replace(old, new)
    cu.write_text(text)
    return tree


def child(tree: Path, *args) -> subprocess.Popen:
    env = dict(os.environ, PYTHONPATH=str(tree / "src"))
    return subprocess.Popen([sys.executable, __file__, *args], env=env)


def run_kernels() -> int:
    trees = [(name, make_tree(name, src, subs)) for name, src, subs in VARIANTS]
    t0 = time.perf_counter()
    builds = [(name, child(tree, "build")) for name, tree in trees]
    failed = {name for name, p in builds if p.wait() != 0}
    print(f"built {len(builds) - len(failed)} of {len(builds)} designs in "
          f"{time.perf_counter() - t0:.1f} s; failed: {sorted(failed)}",
          flush=True)
    rc = int(bool(failed))
    for name, tree in trees + trees[:1]:
        if name not in failed:
            rc |= child(tree, "time", name).wait()
    return rc


def build_one() -> int:
    from repro_torch.kernels import build
    build.build(["commit_batch"])
    return 0


def time_one(label: str) -> int:
    sys.path.insert(0, str(ROOT))
    import torch
    from chip_smoke import (HBM_BYTES_PER_S, RULE_LANES, commit_inputs,
                            measure)
    from repro_torch.kernels import ops
    dev, name = torch.device("cuda"), card()
    for rows, K, d, R in SHAPES:
        kw = commit_inputs(torch, K, d, R, RULE_LANES[R], dev,
                           seed=K + R + d % 997, rows=rows)
        call = lambda: ops.commit_batch(**kw)
        r1, v1, u1 = call()
        r2, v2, u2 = ops.commit_batch(**kw, backend="torch")
        torch.cuda.synchronize()
        same = (torch.equal(r1, r2) and torch.equal(v1, v2)
                and torch.equal(u1, u2))
        row_b = kw["old_rows"].element_size()
        nbytes = d * (K * (4 + 2 * row_b) + 2 * R * 4 + 4)
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        dev_ms, ev_ms, _ = measure(torch, call, 300 if d < 1e6 else 20,
                                   "commit_batch_kernel")
        ms, src = ((dev_ms, "device") if dev_ms is not None and dev_ms >= bound
                   else (ev_ms, "events"))
        print(f"[{label}] {rows} K={K} d={d} R={R}: kernel {ms:.5f} ms "
              f"({src}), bound {bound:.6f} ms, kernel/bound {ms / bound:.2f}, "
              f"bit-identical {same} [{name}]", flush=True)
    return 0


def run_engine(trees) -> int:
    rc = 0
    for tree in trees:
        rc |= child(Path(tree).resolve(), "engine-one", tree).wait()
    return rc


def engine_one(label: str) -> int:
    import numpy as np
    import torch
    from repro_torch.core import (ACEIncremental, make_vision_task,
                                  run_staleness_scan)
    dev, name = torch.device("cuda"), card()
    task = make_vision_task(device=dev)
    T, K = 300, 16
    for rep in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run_staleness_scan(
            grad_fn=task.grad_fn, params0=task.params0,
            aggregator=ACEIncremental(cache_dtype="int8"),
            n_clients=task.n_clients,
            server_lr=0.2 * float(np.sqrt(task.n_clients / T)), T=T,
            beta=5.0, k_batch=K, n_events=T - 1, seed=0, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        print(f"[{label}] run {rep}: {(T - 1) * K / wall:.1f} arrivals/s, "
              f"{1e3 * wall / (T - 1):.4f} ms/tick, "
              f"w[0]={float(res.w[0]):.6e} [{name}]", flush=True)
    return 0


def main(argv) -> int:
    if not argv:
        raise SystemExit(__doc__)
    cmd, rest = argv[0], argv[1:]
    if cmd == "kernels":
        return run_kernels()
    if cmd == "engine" and rest:
        return run_engine(rest)
    if cmd == "build":
        return build_one()
    if cmd == "time":
        return time_one(rest[0])
    if cmd == "engine-one":
        return engine_one(rest[0])
    raise SystemExit(__doc__)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
