#!/usr/bin/env python3
"""Time the quantize_rows and dequantize_rows kernels of
``src/repro_torch/kernels/csrc/quant.cu`` on one GPU: the shipped kernels
over their launch plans (cluster size, vectors a thread), and diagnostic
variants made by text edits of the shipped sources (quant.cu and the
cluster exchange it includes, cluster_row.cuh), beside an earlier tree's
kernels.

    python3 tools/quant_designs.py [--parent DIR]

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
    # a parent from before the launch plans took (x, q, s, n, d, stream)
    old_parent = "parent" in jobs and "int cluster" not in \
        jobs["parent"].read_text()
    for name, lib in libs.items():
        lib.takes_plan = not (name == "parent" and old_parent)
        if not lib.takes_plan:
            lib.quantize_rows.argtypes = [P, P, P, I, L, P]
            lib.dequantize_rows.argtypes = [P, P, P, I, L, P]
        else:
            lib.quantize_rows.argtypes = [P, P, P, I, L, I, I, I, I, P]
            lib.dequantize_rows.argtypes = [P, P, P, I, L, L, I, I, I, L, P]
        lib.quantize_rows.restype = lib.dequantize_rows.restype = I
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="an earlier tree to time beside")
    args = ap.parse_args()
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
            lib = libs[name]
            if plan is None:
                launch = lambda: lib.quantize_rows(
                    x.data_ptr(), q.data_ptr(), s.data_ptr(), n, d, stream)
            else:
                c, t, v, on_chip = plan
                launch = lambda: lib.quantize_rows(
                    x.data_ptr(), q.data_ptr(), s.data_ptr(), n, d, c, t, v,
                    kq.ON_CHIP[on_chip], stream)
            tag = f"quantize_rows ({n}, {d}) {name}" + (
                f" C={plan[0]} threads={plan[1]} {plan[3]}"
                + (f" {plan[2]}/thread" if plan[3] == "registers" else "")
                if plan else "")
            run(tag, launch, same, iters, "quantize_rows_kernel", nbytes)
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
