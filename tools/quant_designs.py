#!/usr/bin/env python3
"""Time the quantize_rows and dequantize_rows kernels of
``src/repro_torch/kernels/csrc/quant.cu`` on one GPU: the shipped kernels
over their launch plans (cluster size, vectors a thread), and diagnostic
variants made by text edits of the shipped sources (quant.cu and the
cluster exchange it includes, cluster_row.cuh), beside an earlier tree's
kernels.

    python3 tools/quant_designs.py [--parent DIR] [--grid]
    python3 tools/quant_designs.py --ticks TREE [TREE ...]

Variants, each built with nvcc into build/quant_designs/:
  shipped      quant.cu as it is;
  pull         the cluster shares its maxima by pull: cluster.sync(), each
               block reads its peers' maxima through distributed shared
               memory, and a second cluster barrier before it leaves;
  no_exchange  each block quantizes with its own block's maximum (wrong
               codes where C > 1): what the exchange costs;
  multiply     a multiply by 1/s in place of the IEEE division (codes may
               differ near ties): what the division costs;
  grid_stride  dequantize_rows on a grid-stride grid of 8 blocks per SM in
               place of one vector a thread over the whole grid.
`--parent DIR` builds DIR/src/repro_torch/kernels/csrc/quant.cu as well and
calls it through that tree's entries: with this tree's launch plans where
it takes them, else as (x, q, s, n, d, stream).

`--grid` times only quantize_rows' cooperative grid against the cluster
plan, from one row of 17,226 numbers to yi-9b's embedding leaf and by 1,
8, 16 and 100 rows (`GRID_SHAPES`): the cluster rule's plan, and the grid
at 4 and 8 loads a thread in flight on as many blocks a row as the card
holds and as leave 2, 4, 8 and 16 vectors a thread, each beside the
single-read bound (5 B a number) and the two-pass floor (9 B); with
`--parent`, the parent's rule too. Where the grid is faster is the
crossover that `_quant_plan`'s rule follows.

`--ticks TREE ...` times the real models' graph tick in each tree, one
process each in the order given (e.g. build/parent . . build/parent, a
tree unpacked under build/ building its own kernels there): that tree's
chip_smoke.py phase 4f and 4g runners (yi-9b at one layer, zamba2-1.2b at
seven, ACE int8 K = 1, 12 ticks), captured, run twice untimed by the
profiler and once traced (chip_smoke.trace_engine: device busy ms a tick,
the matrix products' and the quant kernels' ms a tick).

Each line: device ms per call from torch.profiler (chip_smoke.measure),
each timed kernel run in the order parent, variants, variants reversed,
parent; and whether its output is bit-identical to the plain version.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
OUT = ROOT / "build" / "quant_designs"

PUSH = """      if (lane < C) {
        asm volatile("st.shared::cluster.f32 [%0], %1;"
                     :: "r"(peer_addr(smem_addr(&part[rank]), lane)),
                        "f"(m) : "memory");
        asm volatile(
            "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];"
            :: "r"(peer_addr(b, lane)) : "memory");
      }
    }
    for (uint32_t done = 0; !done;) {
      asm volatile(
          "{\\n.reg .pred p;\\n"
          "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
          "0;\\nselp.u32 %0, 1, 0, p;\\n}"
          : "=r"(done) : "r"(b) : "memory");
    }
    float r = 0.f;
    for (int k = 0; k < C; ++k) r = nan_max(part[k], r);
"""
PULL = """      if (lane == 0) part[0] = m;
    }
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    const float r = warp_max(
        lane < C ? *cluster.map_shared_rank(&part[0], lane) : 0.f);
    asm volatile("barrier.cluster.arrive.aligned;" ::: "memory");
"""
OWN_MAX = """      if (lane == 0) part[0] = m;
    }
    __syncthreads();
    const float r = part[0];
"""
QUANT_END = """        if (i < vhi) put_codes(qv, i, a[u], s, q4);
      }
    }
  }
}
"""
RECIPROCAL = """namespace {

__device__ __forceinline__ float quant_by_reciprocal(float g, float s) {
  return fminf(fmaxf(rintf(g * (1.0f / s)), -127.f), 127.f);
}
"""
ONE_VECTOR = """  if (v >= nvec) return;
  const I i = head + v * W;
"""
STRIDE = """  for (I u = v; u < nvec; u += static_cast<I>(gridDim.x) * blockDim.x) {
  const I i = head + u * W;
"""
DEQUANT_END = """        static_cast<float>(c.w) * (i + 3 < next ? s0 : s1));
  }
}
"""
ALL_VECTORS = "blocks * threads >= (N - head) / width"


def _edit(src, *pairs):
    for old, new in pairs:
        if src.count(old) != 1:
            raise SystemExit(f"source changed: cannot place {old[:40]!r}")
        src = src.replace(old, new)
    return src


def variants():
    """name -> (quant.cu, cluster_row.cuh) of each variant."""
    src = (CSRC / "quant.cu").read_text()
    hdr = (CSRC / "cluster_row.cuh").read_text()
    return {
        "shipped": (src, hdr),
        "pull": (_edit(src, (QUANT_END, QUANT_END[:-2] + (
            '  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");\n'
            "}\n"))), _edit(hdr, (PUSH, PULL))),
        "no_exchange": (src, _edit(hdr, (PUSH, OWN_MAX))),
        "multiply": (_edit(src.replace("repro::quant(", "quant_by_reciprocal("),
                           ("namespace {\n", RECIPROCAL)), hdr),
        "grid_stride": (_edit(src, (ONE_VECTOR, STRIDE),
                              (DEQUANT_END, DEQUANT_END[:-2] + "  }\n}\n"),
                              (ALL_VECTORS, "true")), hdr),
    }


def build_all(parent):
    from repro_torch.kernels import build
    jobs = {}
    for name, (src, hdr) in variants().items():
        # the variant's header beside it, found before the shipped one
        (OUT / name).mkdir(parents=True, exist_ok=True)
        (OUT / name / "cluster_row.cuh").write_text(hdr)
        (OUT / name / "quant.cu").write_text(src)
        jobs[name] = OUT / name / "quant.cu"
    if parent:
        jobs["parent"] = Path(parent) / "src/repro_torch/kernels/csrc/quant.cu"

    def compile_one(item):
        name, path = item
        lib = OUT / f"{name}.so"
        out = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-I",
                              str(CSRC), "-o", str(lib), str(path)],
                             capture_output=True, text=True)
        if out.returncode != 0:
            raise SystemExit(f"{name}: nvcc failed\n{out.stdout}{out.stderr}")
        return name, ctypes.CDLL(str(lib))

    with ThreadPoolExecutor(len(jobs)) as pool:
        libs = dict(pool.map(compile_one, jobs.items()))
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    # a parent from before the launch plans took (x, q, s, n, d, stream),
    # one from before the grid took no `partial`
    text = {name: Path(path).read_text() for name, path in jobs.items()}
    for name, lib in libs.items():
        lib.takes_plan = "int cluster" in text[name]
        lib.takes_partial = "void* partial" in text[name]
        if not lib.takes_plan:
            lib.quantize_rows.argtypes = [P, P, P, I, L, P]
            lib.dequantize_rows.argtypes = [P, P, P, I, L, P]
        else:
            lib.quantize_rows.argtypes = [P, P, P, I, L, I, I, I, I] + (
                [P, P] if lib.takes_partial else [P])
            lib.dequantize_rows.argtypes = [P, P, P, I, L, L, I, I, I, L, P]
        lib.quantize_rows.restype = lib.dequantize_rows.restype = I
    return libs


# (n, d) of the --grid sweep: one row from the vision task's width through
# the cluster's shared-memory reach (462,848) to yi-9b's embedding leaf,
# and the real models' leaves by 8 and 16 rows, and the cache-wide shape
GRID_SHAPES = ((1, 17226), (1, 70996), (1, 131072), (1, 262144),
               (1, 462848), (1, 1048576), (1, 2097152), (1, (1 << 24) + 3),
               (1, 45088768), (1, 65536000), (1, 262144000), (8, 2097152),
               (8, 16777216), (8, 45088768), (16, 2097152), (16, 45088768),
               (100, 17226), (100, (1 << 22) + 3), (2, 131072),
               (8, 131072), (8, 462848), (16, 131072))


def quant_launch(lib, x, q, s, plan, stream):
    """A launch of `lib`'s quantize_rows on `plan` (None: the oldest entry,
    which takes no plan) -> a call returning its CUDA error."""
    import torch
    from repro_torch.kernels import quant as kq
    n, d = x.shape
    if plan is None:
        return lambda: lib.quantize_rows(x.data_ptr(), q.data_ptr(),
                                         s.data_ptr(), n, d, stream)
    c, t, v, on_chip = plan
    partial = (torch.empty(n * c, dtype=torch.float32, device=x.device)
               if on_chip == "grid" else None)
    extra = ([None if partial is None else partial.data_ptr()]
             if lib.takes_partial else [])

    def launch(keep=partial):           # `partial` lives as long as this
        return lib.quantize_rows(x.data_ptr(), q.data_ptr(), s.data_ptr(),
                                 n, d, c, t, v, kq.ON_CHIP[on_chip], *extra,
                                 stream)
    return launch


def plan_tag(plan):
    if plan is None:
        return ""
    c, t, v, on_chip = plan
    if on_chip == "grid":
        return f" grid {c} blocks/row threads={t} {v} loads/thread"
    return f" C={c} threads={t} {on_chip}" + (
        f" {v}/thread" if on_chip == "registers" else "")


def grid_sweep(torch, cs, kq, ref, libs, dev, card, sms, stream):
    """The --grid sweep: each shape's plans in turns (forward, then
    backward), device ms per call, bit-identical to the plain version."""
    for n, d in GRID_SHAPES:
        x = cs.quant_input(torch, n, d, dev, seed=n + d % 1000)
        q0, s0 = ref.quantize_rows_ref(x)
        q, s = torch.empty_like(q0), torch.empty_like(s0)
        iters = 200 if n * d < 1e7 else 10
        nbytes = n * d * 5 + n * 4
        floor = (n * d * 9 + n * 4) / cs.HBM_BYTES_PER_S * 1e3
        plans = [kq._cluster_plan(n, d, sms)]
        most = kq.GRID_BLOCKS_PER_SM * sms // n
        if most >= 1:
            # blocks a row: the card's share, and 2, 4, 8 and 16 vectors a
            # thread (the rule's count among them)
            counts = {most, kq._grid_plan(n, d, sms)[0]} | {
                min(most, max(1, -(-(d // 4) // (kq.GRID_THREADS * v))))
                for v in (2, 4, 8, 16)}
            plans += [(c, kq.GRID_THREADS, loads, "grid")
                      for c in sorted(counts, reverse=True)
                      for loads in (4, 8)]
        runs = [("shipped", p) for p in plans]
        if "parent" in libs:
            runs.insert(0, ("parent", kq._cluster_plan(n, d, sms)
                            if libs["parent"].takes_plan else None))
        for name, plan in runs + runs[::-1]:
            launch = quant_launch(libs[name], x, q, s, plan, stream)
            if launch() != 0:
                raise SystemExit(f"({n}, {d}) {name}{plan_tag(plan)}: "
                                 "launch refused")
            torch.cuda.synchronize()
            same = bool(torch.equal(q, q0) and torch.equal(s, s0))
            ms, ev_ms, _ = cs.measure(torch, launch, iters,
                                      cs.KERNEL_SYMBOLS["quantize_rows"])
            print(f"quantize_rows ({n}, {d}) {name}{plan_tag(plan)}: "
                  f"{cs._fmt(ms)} ms device, {ev_ms:.5f} ms events, "
                  f"bit-identical {same}, bound "
                  f"{nbytes / cs.HBM_BYTES_PER_S * 1e3:.6f} ms, two-pass "
                  f"floor {floor:.6f} ms [{card}]", flush=True)
        del x, q0, q


def tick_child(tree, card):
    """In a process of its own: `tree`'s real-model graph ticks, through
    that tree's chip_smoke.py and repro_torch."""
    tree = Path(tree).resolve()
    sys.path[:0] = [str(tree / "src"), str(tree)]
    import torch

    import chip_smoke as cs
    from repro_torch.core import make_lm_task
    from repro_torch.kernels import build, ops
    from repro_torch.optim import sqrt_nt_schedule
    build.build()
    dev = torch.device("cuda")
    lr = sqrt_nt_schedule(cs.LM_LR_SCALE, cs.LM_TASK["n_clients"],
                          cs.LM_STEPS)(0)
    E = cs.LM_TICKS
    for phase in ("4f", "4g"):
        task = make_lm_task(cfg=cs.lm_config(phase), device=dev,
                            **cs.LM_TASK)
        args = (*cs.engine_streams(task, 1, E, dev), lr)
        runner = cs.lm_runner(task, "ace", 1, dev, None)
        cs.run_engine(torch, runner, *args)             # the capture
        walls = [cs.run_engine(torch, runner, *args)[1] for _ in range(2)]
        tick_ms = 1e3 * sum(walls) / 2 / E
        print(f"ticks {tree.name or tree} {phase}: graph wall ms a tick "
              f"{', '.join(f'{1e3 * w / E:.2f}' for w in walls)} [{card}]",
              flush=True)
        cs.trace_engine(torch, ops, f"{phase} ace int8 K=1 graph ({tree})",
                        runner, args, E, tick_ms, card,
                        must=cs.TREE_KERNELS, top=4, groups=cs.LM_GROUPS)
        del runner, task
        cs.free(torch)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="an earlier tree to time beside")
    ap.add_argument("--grid", action="store_true",
                    help="only the grid against the cluster plan")
    ap.add_argument("--ticks", nargs="+", metavar="TREE",
                    help="the real models' graph ticks in these trees")
    ap.add_argument("--tick-child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.tick_child or args.ticks:
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True,
                              text=True, check=True).stdout.strip()
        if args.tick_child:
            tick_child(args.tick_child, card)
            return 0
        print(card, flush=True)
        for tree in args.ticks:
            subprocess.run([sys.executable, __file__, "--tick-child", tree],
                           check=True)
        return 0
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import quant as kq
    from repro_torch.kernels import ref
    if not torch.cuda.is_available():
        print("quant_designs: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    libs = build_all(args.parent)
    dev = torch.device("cuda")
    sms = kq._sm_count(dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if args.grid:
        grid_sweep(torch, cs, kq, ref, libs, dev, card, sms, stream)
        return 0

    def run(tag, launch, check, iters, kernel, nbytes):
        if launch() != 0:
            raise SystemExit(f"{tag}: launch refused")
        torch.cuda.synchronize()
        ms, _, _ = cs.measure(torch, lambda: launch(), iters, kernel)
        print(f"{tag}: {cs._fmt(ms)} ms, bit-identical {check()}, bound "
              f"{nbytes / cs.HBM_BYTES_PER_S * 1e3:.6f} ms [{card}]",
              flush=True)

    for n, d in ((1, 17226), (100, 17226), (100, (1 << 22) + 3)):
        x = cs.quant_input(torch, n, d, dev, seed=n + d % 1000)
        q0, s0 = ref.quantize_rows_ref(x)
        q, s = torch.empty_like(q0), torch.empty_like(s0)
        iters, nbytes = (200 if n * d < 1e7 else 10), n * d * 5 + n * 4
        same = lambda: bool(torch.equal(q, q0) and torch.equal(s, s0))
        plans = [kq._quant_plan(n, d, sms, cluster=c) for c in (1, 2, 4, 8)]
        if d < 1e6:         # vectors a thread at C = 8
            most = -(-(d // 4) // 8)
            plans += [(8, (-(-most // v) + 31) // 32 * 32, v, "registers")
                      for v in (2, 4, 8) if -(-most // v) <= kq.MAX_THREADS]
        rule = kq._quant_plan(n, d, sms)
        runs = [("parent", rule if libs["parent"].takes_plan else None)] \
            if "parent" in libs else []
        runs += [("shipped", p) for p in dict.fromkeys(plans)]
        runs += [(v, rule) for v in ("pull", "no_exchange", "multiply")]
        for name, plan in runs + runs[::-1]:
            launch = quant_launch(libs[name], x, q, s, plan, stream)
            run(f"quantize_rows ({n}, {d}) {name}{plan_tag(plan)}", launch,
                same, iters, cs.KERNEL_SYMBOLS["quantize_rows"], nbytes)
        del x, q0, q

    for n, d in ((100, 17226), (100, (1 << 22) + 3)):
        q, s = ref.quantize_rows_ref(cs.quant_input(torch, n, d, dev,
                                                    seed=7 + n))
        x0 = torch.mul(q, s[:, None])
        x = torch.empty_like(x0)
        iters, nbytes = (200 if n * d < 1e7 else 10), n * d * 5 + n * 4
        head, width, vec_q, threads, blocks = kq._dequant_plan(
            n, d, q.data_ptr(), x.data_ptr())
        strided = min(blocks, 8 * sms)
        runs = [("parent", blocks if libs["parent"].takes_plan else None)] \
            if "parent" in libs else []
        runs += [("shipped", blocks), ("grid_stride", strided)]
        for name, grid in runs + runs[::-1]:
            lib = libs[name]
            if grid is None:
                launch = lambda: lib.dequantize_rows(
                    q.data_ptr(), s.data_ptr(), x.data_ptr(), n, d, stream)
            else:
                launch = lambda: lib.dequantize_rows(
                    q.data_ptr(), s.data_ptr(), x.data_ptr(), n, d, head,
                    width, int(vec_q), threads, grid, stream)
            run(f"dequantize_rows ({n}, {d}) {name}"
                + (f" {grid} blocks of {threads}" if grid else ""), launch,
                lambda: bool(torch.equal(x, x0)), iters,
                "dequantize_rows_kernel", nbytes)
        del q, x0, x
    return 0


if __name__ == "__main__":
    sys.exit(main())
