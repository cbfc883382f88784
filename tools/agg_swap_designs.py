#!/usr/bin/env python3
"""Time `masked_agg` (``csrc/masked_agg.cu``), the fused int8 row swap
(``csrc/row_delta.cu``, `FlatCache.set_row_delta`) and the whole int8 ACE
step (``csrc/cache_update.cu``, `ACEIncremental.step`) on one GPU, beside
an earlier tree's.

    python3 tools/agg_swap_designs.py [--parent DIR] [--rows-only]

masked_agg at (100, 17,226) and (100, 2^22 + 3), each timed kernel run in
the order parent, variants, variants reversed, parent:
  shipped            masked_agg.cu as it is;
  regs               one thread a feature, 16 rows of byte loads in flight
                     from device memory before their adds, no shared memory;
  no_sum             diagnostic: the adds left out (wrong output);
  no_weights         diagnostic: no mask, scale or count loads (w = 1);
  no_weights_no_sum  diagnostic: both;
  empty              diagnostic: the launch alone (same grid, same shared
                     memory).
`--parent DIR` also builds DIR's masked_agg.cu and calls its entry.

Then, in this tree and in DIR (each in its own process, parent, this,
this, parent): the whole int8 `FlatCache.set_row_delta` call at d = 17,226
and 2^24 + 3 (device time and device kernels per call, from torch.profiler;
at 17,226 also the row swap forced onto the cooperative grid), the whole
int8 `ACEIncremental.step` call at K = 1 at the same widths for f32 and
bf16 states (at 17,226 also its kernel on each cluster size and on the
grid, in a tree whose kernel takes a plan), and one traced 300-tick int8
K = 1 run each of ACED and ACE on the vision task (device kernels and
device time per tick, wall clock, idle share, arrivals/s), in a tree with
the engine's runner once with the tick captured as a CUDA graph and once
eagerly. Each line: device ms per call (chip_smoke.measure) and, for
masked_agg, whether the output is bit-identical to the plain version.
`--rows-only` skips masked_agg.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
OUT = ROOT / "build" / "agg_swap_designs"

REGS = r'''
#include "common.cuh"
namespace {
constexpr int kRows = 16;
__global__ void __launch_bounds__(128) masked_agg_regs_kernel(
    const int8_t* __restrict__ cache, const float* __restrict__ scales,
    const bool* __restrict__ mask, float* __restrict__ out, int n,
    long long d) {
  __shared__ float w[128];
  __shared__ int warp_counts[4];
  __shared__ float denom;
  const int tid = threadIdx.x;
  const long long j = static_cast<long long>(blockIdx.x) * 128 + tid;
  const bool own = j < d;
  const int8_t* col = cache + (own ? j : 0);
  int8_t c[kRows];
#pragma unroll
  for (int k = 0; k < kRows; ++k)
    c[k] = (own && k < n) ? col[static_cast<long long>(k) * d] : 0;
  int count = 0;
  for (int i = tid; i < n; i += 128) count += mask[i] ? 1 : 0;
  for (int off = 16; off > 0; off >>= 1)
    count += __shfl_down_sync(0xffffffffu, count, off);
  if ((tid & 31) == 0) warp_counts[tid >> 5] = count;
  __syncthreads();
  if (tid == 0)
    denom = fmaxf(static_cast<float>(warp_counts[0] + warp_counts[1] +
                                     warp_counts[2] + warp_counts[3]), 1.f);
  __syncthreads();
  for (int r = tid; r < n; r += 128) {
    const float m = mask[r] ? 1.f : 0.f;
    w[r] = m * scales[r] / denom;
  }
  __syncthreads();
  float acc = 0.f;
  for (int r0 = 0; r0 < n; r0 += kRows) {
    int8_t nx[kRows];
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      const int r = r0 + kRows + k;
      nx[k] = (own && r < n) ? col[static_cast<long long>(r) * d] : 0;
    }
#pragma unroll
    for (int k = 0; k < kRows; ++k)
      if (r0 + k < n) acc = acc + w[r0 + k] * static_cast<float>(c[k]);
#pragma unroll
    for (int k = 0; k < kRows; ++k) c[k] = nx[k];
  }
  if (own) out[j] = acc;
}
}  // namespace
REPRO_EXPORT int masked_agg(const void* cache, const void* scales,
                            const void* mask, void* out, int n, long long d,
                            int rows, long long blocks, void* stream) {
  if (n > 128) return static_cast<int>(cudaErrorInvalidValue);
  masked_agg_regs_kernel<<<static_cast<unsigned>((d + 127) / 128), 128, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(cache), static_cast<const float*>(scales),
      static_cast<const bool*>(mask), static_cast<float*>(out), n, d);
  return static_cast<int>(cudaGetLastError());
}
'''
WEIGHTS = """    const bool m = has && mask[c0 + tid];
    const float sc = has ? scales[c0 + tid] : 0.f;"""
COUNT = """      int total = __syncthreads_count(m);
      for (int i0 = rc; i0 < n; i0 += kF)
        total += __syncthreads_count(i0 + tid < n && mask[i0 + tid]);
      denom = fmaxf(static_cast<float>(total), 1.f);"""
SUM_START = "    if (j0 + tid < d) {\n      unsigned off"
SUM_END = "    __syncthreads();   // the chunk's readers"
LOOP = "for (int c0 = 0; c0 < n; c0 += rows) {"


def _edit(src, *pairs):
    for old, new in pairs:
        if src.count(old) != 1:
            raise SystemExit(f"masked_agg.cu changed: cannot place "
                             f"{old[:40]!r}")
        src = src.replace(old, new)
    return src


def _no_sum(src):
    a, b = src.index(SUM_START), src.index(SUM_END)
    return src[:a] + "    acc = w[0];\n" + src[b:]


def variants():
    src = (CSRC / "masked_agg.cu").read_text()
    no_w = _edit(src, (WEIGHTS, "    const bool m = has;\n"
                                "    const float sc = 1.f;"), (COUNT, ""))
    return {"shipped": src, "regs": REGS, "no_sum": _no_sum(src),
            "no_weights": no_w, "no_weights_no_sum": _no_sum(no_w),
            "empty": _edit(src, (LOOP, LOOP.replace("c0 < n", "c0 < 0")))}


def card():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()


def kernels(parent):
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import masked_agg as ma
    OUT.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name, text in variants().items():
        (OUT / f"{name}.cu").write_text(text)
        jobs[name] = (OUT / f"{name}.cu", CSRC)
    if parent:
        pcsrc = Path(parent) / "src/repro_torch/kernels/csrc"
        jobs["parent"] = (pcsrc / "masked_agg.cu", pcsrc)

    def compile_one(item):
        name, (src, inc) = item
        lib = OUT / f"{name}.so"
        out = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-I", str(inc),
                              "-o", str(lib), str(src)], capture_output=True,
                             text=True)
        if out.returncode:
            raise SystemExit(f"{name}: nvcc failed\n{out.stdout}{out.stderr}")
        return name, ctypes.CDLL(str(lib))

    with ThreadPoolExecutor(len(jobs)) as pool:
        libs = dict(pool.map(compile_one, jobs.items()))
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for name, lib in libs.items():
        # the parent of the 128-feature tiles took (…, n, d, stream)
        old = name == "parent" and "long long blocks" not in \
            jobs[name][0].read_text()
        lib.masked_agg.argtypes = ([P] * 4 + [I, L, P] if old
                                   else [P] * 4 + [I, L, I, L, P])
        lib.masked_agg.restype = I
    dev = torch.device("cuda")
    st = torch.cuda.current_stream(dev).cuda_stream
    tag = card()
    print(tag, flush=True)
    for n, d in ((100, 17226), (100, (1 << 22) + 3)):
        g = torch.Generator(device=dev).manual_seed(n + d % 997)
        q, s = ref.quantize_rows_ref(torch.randn(n, d, generator=g,
                                                 device=dev))
        mask = torch.rand(n, generator=g, device=dev) < 0.4
        u0 = ref.masked_agg_ref(q, s, mask)
        out = torch.empty_like(u0)
        rows, blocks = ma._agg_plan(n, d)
        iters = 200 if d < 1e6 else 10
        names = (["parent"] if parent else []) + list(variants())
        for name in names + names[::-1]:
            lib = libs[name]
            args = [q.data_ptr(), s.data_ptr(), mask.data_ptr(),
                    out.data_ptr(), n, d]
            if len(lib.masked_agg.argtypes) == 9:
                args += [rows, blocks]
            launch = lambda: lib.masked_agg(*args, st)   # noqa: E731
            if launch() != 0:
                raise SystemExit(f"{name}: launch refused")
            torch.cuda.synchronize()
            same = bool(torch.equal(out, u0))
            kname = "masked_agg_regs" if name == "regs" else \
                "masked_agg_kernel"
            ms, _, _ = cs.measure(torch, launch, iters, kname)
            print(f"masked_agg ({n}, {d}) {name}: {cs._fmt(ms)} ms, "
                  f"bit-identical {same}, bound "
                  f"{(n * d + 5 * n + 4 * d) / cs.HBM_BYTES_PER_S * 1e3:.6f} "
                  f"ms [{tag}]", flush=True)
        del q, out


def _tick(cs, torch, task, rule, dev, label, tag):
    """One traced 300-tick int8 K = 1 run of `rule` (after a warm run, which
    also captures the graph, and an untraced one for the wall clock) for
    each way the tree runs the engine: its runner with the tick captured as
    a CUDA graph and eagerly, or, in a tree from before the runner, its
    `run_staleness_scan` loop. Device kernels and device time per tick,
    idle share, arrivals/s."""
    import repro_torch.core as core
    T, E = cs._depth(rule, 1)
    streams, lr = cs.engine_streams(task, 1, E, dev), cs.engine_lr(task, T)
    if hasattr(core, "make_staleness_runner"):
        modes = {"graph": cs.engine_runner(task, rule, "int8", 1, T, dev),
                 "eager": cs.engine_runner(task, rule, "int8", 1, T, dev,
                                           graph=False)}
    else:
        def loop(randomness, payload_noise, lr):
            return core.run_staleness_scan(
                grad_fn=task.grad_fn, params0=task.params0,
                aggregator=cs.make_rule(rule, "int8", 1),
                n_clients=task.n_clients, server_lr=lr, T=T, beta=5.0,
                device=dev, randomness=randomness,
                payload_noise=payload_noise)
        modes = {"loop": loop}
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for mode, runner in modes.items():
        cs.run_engine(torch, runner, streams, lr)          # warm
        _, wall = cs.run_engine(torch, runner, streams, lr)
        with torch.profiler.profile(activities=acts) as prof:
            cs.run_engine(torch, runner, streams, lr)
        evs = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
        busy = sum(e.self_device_time_total for e in evs) / 1e3 / E
        per = sum(e.count for e in evs) / E
        tick = 1e3 * wall / E
        print(f"{label}: engine {rule} int8 K=1 {mode}: {per:.1f} device "
              f"kernels per tick, device busy {busy:.4f} ms of {tick:.4f} "
              f"ms wall, idle share {1 - busy / tick:.3f}, "
              f"{E / wall:.1f} arrivals/s [{tag}]", flush=True)


def _ace_step(cs, torch, dev, label, tag):
    """The whole int8 ACEIncremental.step call at K = 1 (f32 and bf16
    states), device time and device kernels per call; in a tree whose
    cache_row_update takes a plan, also the kernel on every cluster size
    that fits and on the cooperative grid at d = 17,226."""
    import inspect

    from repro_torch.core.aggregators import ACEIncremental, Arrival
    from repro_torch.core.cache import FlatCache
    from repro_torch.kernels import cache_update as cu
    from repro_torch.kernels import quant, ref
    for d in (17226, (1 << 24) + 3):
        g = torch.Generator(device=dev).manual_seed(d % 1000 + 1)
        data, scale = ref.quantize_rows_ref(
            torch.randn(4, d, generator=g, device=dev) * 3)
        row = torch.tensor([2], device=dev)
        x = torch.randn(d, generator=g, device=dev) * 5
        u = torch.randn(d, generator=g, device=dev)
        iters = 200 if d < 1e6 else 20
        for state in (torch.float32, torch.bfloat16):
            st = {"cache": FlatCache(data, scale), "u": u.to(state)}
            agg = ACEIncremental(cache_dtype="int8")
            arr = Arrival(row, x, 1, 0)
            ms, _, per = cs.measure(torch, lambda: agg.step(st, arr), iters,
                                    None)
            print(f"{label}: ACEIncremental.step int8 d={d} "
                  f"{str(state)[6:]} state: {cs._fmt(ms)} ms device, "
                  f"{per:g} device kernels per call [{tag}]", flush=True)
        if d < 1e6 and "plan" in inspect.signature(
                cu.cache_row_update).parameters:
            sms = quant._sm_count(dev)
            plans = [quant._quant_plan(1, d, sms, c) for c in (1, 2, 4, 8)]
            plans = [p for p in plans if p[3] == "registers"
                     and p[2] <= cu.MAX_PER_THREAD]
            for plan in plans + [(1, 32, 2, "grid")]:
                ms, _, _ = cs.measure(torch, lambda: cu.cache_row_update(
                    data, scale, row, x, u, 0.01, plan=plan), iters,
                    "cache_update")
                print(f"{label}: cache_row_update d={d} plan {plan}: "
                      f"{cs._fmt(ms)} ms device [{tag}]", flush=True)
        del data, scale, x, u


def swap_and_tick(tree):
    """In `tree`'s package: the whole int8 set_row_delta call, the whole
    int8 ACE step and one traced int8 K = 1 engine run each of ACED and
    ACE."""
    import torch

    import chip_smoke as cs
    from repro_torch.core import make_vision_task
    from repro_torch.core.cache import FlatCache
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import row_delta as rd
    build.build(["row_delta", "quant", "cache_update"])
    dev = torch.device("cuda")
    label, tag = Path(tree).resolve().name, card()
    for d in (17226, (1 << 24) + 3):
        g = torch.Generator(device=dev).manual_seed(d % 1000)
        data, scale = ref.quantize_rows_ref(
            torch.randn(4, d, generator=g, device=dev) * 3)
        row = torch.tensor([1], device=dev)
        x = torch.randn(d, generator=g, device=dev) * 5
        cache = FlatCache(data, scale)
        ms, _, per = cs.measure(torch, lambda: cache.set_row_delta(row, x),
                                200 if d < 1e6 else 20, None)
        print(f"{label}: FlatCache.set_row_delta int8 d={d}: {cs._fmt(ms)} "
              f"ms device, {per:g} device kernels per call [{tag}]",
              flush=True)
        if d < 1e6 and hasattr(rd, "_row_plan"):
            # the cooperative grid, which the plan keeps for longer rows
            grid = rd._row_plan(d, 132)[:3] + ("grid",)
            ms, _, _ = cs.measure(torch, lambda: rd.row_delta(
                data, scale, row, x, plan=grid), 200, "row_delta")
            print(f"{label}: row swap d={d} on the cooperative grid: "
                  f"{cs._fmt(ms)} ms device [{tag}]", flush=True)
        del data, scale, x, cache
    _ace_step(cs, torch, dev, label, tag)
    task = make_vision_task(device=dev)
    for rule in ("aced", "ace"):
        _tick(cs, torch, task, rule, dev, label, tag)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="an earlier tree to time beside")
    ap.add_argument("--rows-only", action="store_true",
                    help="skip masked_agg; only the row calls and the ticks")
    ap.add_argument("--tree", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.tree:                       # one tree's calls, in its process
        sys.path[:0] = [str(Path(args.tree).resolve() / "src"), str(ROOT)]
        swap_and_tick(args.tree)
        return 0
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch
    if not torch.cuda.is_available():
        print("agg_swap_designs: no CUDA device", file=sys.stderr)
        return 2
    if not args.rows_only:
        kernels(args.parent)
    trees = [ROOT, ROOT]
    if args.parent:
        trees = [args.parent] + trees + [args.parent]
    for tree in trees:
        subprocess.run([sys.executable, __file__, "--tree", str(tree)],
                       check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
