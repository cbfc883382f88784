"""Production dry run of the port: every (arch × input shape × mesh) traced
over fake tensors — memory per rank, FLOPs, collective bytes and a roofline
on one NVIDIA H100 — the port of `repro.launch.dryrun`.

Nothing is lowered and nothing is allocated. The model's parameters come
from `model.init` on the meta device (`_MetaGenerator`: shapes and dtypes
only); the step, prefill or decode then runs once under
`torch._subclasses.fake_tensor.FakeTensorMode` on fake tensors of the
trace device (``cuda`` where a card is present, else ``cpu``: a CPU-only
PyTorch cannot index a fake CUDA tensor), with
`torch.distributed._tools.mem_tracker.MemTracker` taking the peak of live
memory, `torch.utils.flop_counter.FlopCounterMode` counting FLOPs, and a
`CommDebugMode` (`_CommBytes`) counting the collectives the step issues
under a fake process group of the mesh's world size. On a fake CUDA tensor
the kernel wrappers would launch their kernels, so the traced step takes
``backend="torch"``, the plain versions: its peak is the plain path's.

The production meshes are axis sizes, ``{"data": 16, "model": 16}`` and
``{"pod": 2, "data": 16, "model": 16}`` with ``--multi-pod``
(`launch.mesh.make_production_mesh` needs a live world of 256 ranks). Two
argument sizes per rank are reported:

  * ``spec_argument_bytes_per_rank`` — params, optimizer state, AFL state
    and batch (or cache and tokens), each leaf divided as the
    ``sharding.auto.infer_*_shardings`` specs say: the JAX package's layout
    (its ``memory_analysis`` argument size);
  * ``held_argument_bytes_per_rank`` — what the port holds per rank today:
    every argument whole. `sharding.rules.shard` and `replicate` hand their
    argument back, so the model, the train step and decode replicate their
    parameters and activations on every rank; only the staleness runner's
    flat server state is blocked (`core.cache.BlockedFlatCache`), and no
    mode here holds one.

``peak_bytes_per_rank`` is the MemTracker peak of the whole traced step,
arguments included, at the probe depths (`probe_costs`), extrapolated to
full depth; FLOPs and collective bytes are extrapolated the same way. Since
every rank computes the whole step, ``t_compute`` and ``t_memory`` divide
the whole step's analytic FLOPs and bytes (`launch.analytic`) by one card's
peaks; ``spec_t_compute`` and ``spec_t_memory`` divide by the chips, as the
JAX package's layout would. ``fits_one_card`` says whether the held
arguments and the peak stay within the card's 80 GB. The traced step does
not depend on the mesh (every argument is whole), so `main` traces each
(arch, shape) once and the second mesh's record reuses the probes.

Peaks are the NVIDIA H100 SXM5 80GB HBM3 datasheet's (dense), chosen by the
config's dtype. JAX's ``--keep-hlo`` has no counterpart (there is no HLO)
and is dropped.

    python -m repro_torch.launch.dryrun --arch all --shape all --both-meshes
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import math
import os
import time
from typing import Dict, Optional

import torch

from repro_torch.configs.base import INPUT_SHAPES, InputShape
from repro_torch.configs.registry import (ARCHS, afl_config, get_config,
                                          input_specs, skip_reason,
                                          supports_shape)
from repro_torch.core.distributed import AFLTrainState, make_afl_train_step
from repro_torch.launch.analytic import analytic_costs
from repro_torch.models import build_model
from repro_torch.optim import sgd
from repro_torch.sharding.auto import (infer_afl_shardings,
                                       infer_batch_shardings,
                                       infer_decode_cache_shardings,
                                       infer_opt_shardings,
                                       infer_params_shardings)
from repro_torch.sharding.rules import axis_sizes, use_rules

#: the card the roofline is drawn for, and its datasheet peaks (dense)
HARDWARE = "NVIDIA H100 SXM5 80GB HBM3 (datasheet peaks, dense)"
PEAK_FLOPS = {"bfloat16": 989.4e12, "float16": 989.4e12, "float32": 66.9e12}
HBM_BW = 3.35e12             # bytes/s
NVLINK_BW = 450e9            # bytes/s each way
CARD_BYTES = 80e9            # device memory

#: collective kinds, as JAX's `collective_bytes` names them
KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")
#: op name (c10d or functional) -> kind
_COLL_OPS = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "all_to_all_single": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
    "broadcast_": "collective-permute",
}


def production_mesh(multi_pod: bool = False) -> Dict[str, int]:
    """The production mesh's axis sizes (256 ranks, or 512 with
    `multi_pod`)."""
    if multi_pod:
        return {"pod": 2, "data": 16, "model": 16}
    return {"data": 16, "model": 16}


def trace_device() -> str:
    """Where the fake tensors say they live: the card where there is one,
    else the CPU (a CPU-only PyTorch cannot index a fake CUDA tensor)."""
    return "cuda" if torch.cuda.is_available() else "cpu"


class _MetaGenerator(torch.Generator):
    """A generator whose device is ``meta``: `model.init` draws on its
    generator's device, so the parameters come out as meta tensors (a
    truncated normal skips its rejection loop on them), nothing
    allocated."""

    @property
    def device(self):
        return torch.device("meta")


# ---------------------------------------------------------------------------
# Trees: walking, bytes under specs, fake stand-ins
# ---------------------------------------------------------------------------

def _walk(tree, specs=None):
    """(leaf, spec) pairs over `tree` (dicts by sorted key, lists, tuples,
    named tuples) and the matching node of `specs` (a spec is a tuple, so
    the walk follows `tree`'s structure). Non-tensor leaves are skipped."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], None if specs is None else specs[k])
    elif isinstance(tree, (list, tuple)):
        for i, x in enumerate(tree):
            yield from _walk(x, None if specs is None else specs[i])
    elif isinstance(tree, torch.Tensor):
        yield tree, specs


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def _split(spec, sizes: Dict[str, int]) -> int:
    """How many ways a spec splits its leaf on a mesh of `sizes`."""
    div = 1
    for s in spec or ():
        for a in (s if isinstance(s, tuple) else (s,)):
            if a is not None:
                div *= sizes[a]
    return div


def tree_bytes(tree, specs=None, sizes=None) -> int:
    """Bytes of `tree`'s tensors; with `specs`, per rank of the mesh of
    axis `sizes` (each leaf divided as its spec splits it)."""
    return sum(_nbytes(x) // (1 if specs is None else _split(s, sizes))
               for x, s in _walk(tree, specs))


def _map(fn, tree):
    """`fn` over `tree`'s tensors (named tuples kept)."""
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(fn, x) for x in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, x) for x in tree)
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


def _fake(tree, device):
    """Stand-ins for a meta tree on `device`, made inside the fake mode
    (so the memory tracker sees them allocated)."""
    return _map(lambda m: torch.empty(tuple(m.shape), dtype=m.dtype,
                                      device=device), tree)


# ---------------------------------------------------------------------------
# The arguments of each mode (meta trees) and their specs
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=4)
def meta_params(cfg):
    """`cfg`'s parameters as meta tensors (shared, never written: every
    mode builds its own state around them)."""
    return build_model(cfg).init(_MetaGenerator(), device="meta")


def _scalar_meta():
    return torch.empty((), dtype=torch.int32, device="meta")


def train_args(cfg, shape: InputShape, aflc, *, lr=0.01, fsdp=True,
               mesh=None):
    """The train step's arguments as meta trees, ``(state, batch, client,
    staleness)``, and their specs on `mesh` (None without one)."""
    params = meta_params(cfg)
    init_fn, _ = make_afl_train_step(build_model(cfg).loss_fn, aflc,
                                     sgd(lr), backend="torch")
    state = init_fn(params)
    batch = input_specs(cfg, shape)["batch"]
    args = (state, batch, _scalar_meta(), _scalar_meta())
    if mesh is None:
        return args, None
    specs = (AFLTrainState(
        params=infer_params_shardings(state.params, mesh, fsdp=fsdp),
        opt_state=infer_opt_shardings(state.opt_state, mesh),
        afl=infer_afl_shardings(state.afl, mesh), step=()),
        infer_batch_shardings(batch, mesh), (), ())
    return args, specs


def prefill_args(cfg, shape: InputShape, mesh=None):
    """``(params, batch)`` as meta trees, and their specs."""
    params = meta_params(cfg)
    batch = input_specs(cfg, shape)["batch"]
    if mesh is None:
        return (params, batch), None
    return (params, batch), (infer_params_shardings(params, mesh),
                             infer_batch_shardings(batch, mesh))


def decode_args(cfg, shape: InputShape, mesh=None):
    """``(params, cache, tokens, pos)`` as meta trees, and their specs."""
    params = meta_params(cfg)
    specs = input_specs(cfg, shape)
    args = (params, specs["cache"], specs["tokens"], specs["pos"])
    if mesh is None:
        return args, None
    return args, (infer_params_shardings(params, mesh),
                  infer_decode_cache_shardings(specs["cache"], mesh,
                                               shape.global_batch),
                  infer_batch_shardings(specs["tokens"], mesh), ())


# ---------------------------------------------------------------------------
# One traced step
# ---------------------------------------------------------------------------

def _coll_bytes(name: str, kind: str, args) -> int:
    """JAX's per-device traffic of one collective (`collective_bytes`):
    all-gather = the result, all-reduce = 2 × size, reduce-scatter =
    result × k (the operand), all-to-all and permutes = size. A c10d op
    (``allreduce_``, ``_allgather_base_``, ...) takes its outputs first
    and, for a reduce-scatter, its operands second; a functional one
    (``all_gather_into_tensor(input, group_size, ...)``) its input first."""
    def size(x):
        return sum(_nbytes(t) for t, _ in _walk(x))
    if kind == "all-reduce":
        return 2 * size(args[0])
    c10d = name.endswith("_")
    if kind == "all-gather":
        return size(args[0]) * (1 if c10d else int(args[1]))
    if kind == "reduce-scatter":
        return size(args[1] if c10d else args[0])
    return size(args[0])


def _comm_mode():
    """A `CommDebugMode` that also sums each collective's bytes by kind."""
    from torch.distributed.tensor.debug import CommDebugMode

    class _CommBytes(CommDebugMode):
        def __init__(self):
            super().__init__()
            self.bytes = dict.fromkeys(KINDS, 0)

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = func.overloadpacket.__name__
            kind = _COLL_OPS.get(name)
            if kind is not None:
                self.bytes[kind] += _coll_bytes(name, kind, args)
            return super().__torch_dispatch__(func, types, args, kwargs)

    return _CommBytes()


@contextlib.contextmanager
def fake_world(world: int):
    """A fake process group of `world` ranks (this process rank 0) for the
    length of the block, unless a group is already initialised."""
    import torch.distributed as dist
    if dist.is_initialized():
        yield
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def measure(args, run, *, mesh=None) -> Dict:
    """Run ``run(*fake args)`` once over fake tensors of `args`' meta trees
    -> ``{"flops", "peak_bytes", "coll_bytes", "coll_detail",
    "coll_counts"}``: FlopCounterMode's FLOPs, MemTracker's peak on the
    trace device (the arguments included, made inside the tracker) and the
    collectives' bytes by kind, under `use_rules(mesh)` when given."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.utils.flop_counter import FlopCounterMode
    device = trace_device()
    tracker = MemTracker()
    rules = use_rules(mesh) if mesh is not None else contextlib.nullcontext()
    with FakeTensorMode(), tracker, rules:
        fake = _fake(args, device)
        with _comm_mode() as comm, FlopCounterMode(display=False) as fc:
            run(*fake)
    peak = sum(snap.get("Total", 0) for dev, snap in
               tracker.get_tracker_snapshot("peak").items()
               if torch.device(dev).type == torch.device(device).type)
    detail = dict(comm.bytes)
    return {"flops": float(fc.get_total_flops()), "peak_bytes": float(peak),
            "coll_bytes": float(sum(detail.values())), "coll_detail": detail,
            "coll_counts": int(comm.get_total_counts())}


def trace_train(arch, shape: InputShape, mesh=None, *, algo="ace",
                remat="full", lr=0.01, cfg=None, fsdp=True,
                cache_dtype=None, **afl_over):
    """One AFL train step (`make_afl_train_step` with the arch's
    `afl_config`, ``backend="torch"``) over fake tensors -> (`measure`'s
    record, the arguments' meta trees and specs, cfg)."""
    cfg = cfg or get_config(arch, shape=shape.name, dtype="bfloat16")
    over = {"algorithm": algo, **afl_over}
    if cache_dtype:
        over["cache_dtype"] = cache_dtype
    aflc = afl_config(arch, **over)
    model = build_model(cfg)
    args, specs = train_args(cfg, shape, aflc, lr=lr, fsdp=fsdp, mesh=mesh)
    _, step_fn = make_afl_train_step(
        lambda p, b: model.loss_fn(p, b, remat=remat), aflc, sgd(lr),
        backend="torch")
    return measure(args, step_fn, mesh=mesh), (args, specs), cfg


def trace_prefill(arch, shape: InputShape, mesh=None, cfg=None):
    """One prefill over fake tensors -> (record, (args, specs), cfg)."""
    cfg = cfg or get_config(arch, shape=shape.name, dtype="bfloat16")
    model = build_model(cfg)
    args, specs = prefill_args(cfg, shape, mesh)
    return measure(args, model.prefill, mesh=mesh), (args, specs), cfg


def trace_decode(arch, shape: InputShape, mesh=None, cfg=None):
    """One decode step against a seq_len-deep cache over fake tensors ->
    (record, (args, specs), cfg)."""
    cfg = cfg or get_config(arch, shape=shape.name, dtype="bfloat16")
    model = build_model(cfg)
    args, specs = decode_args(cfg, shape, mesh)
    return measure(args, model.decode_step, mesh=mesh), (args, specs), cfg


# ---------------------------------------------------------------------------
# Probes: reduced-depth traces, linearly extrapolated to full depth
# ---------------------------------------------------------------------------

def _with_reps(cfg, reps_per_stage, enc_reps):
    stages = tuple((pat, r) for (pat, _), r in zip(cfg.stages, reps_per_stage))
    nl = sum(len(p) * r for p, r in stages)
    return dataclasses.replace(
        cfg, stages=stages, num_layers=nl, scan_layers=False,
        num_encoder_layers=enc_reps if cfg.is_encoder_decoder else 0)


def _trace(arch, shape, mesh, cfg, algo, remat, **train_kw):
    if shape.mode == "train":
        return trace_train(arch, shape, mesh, algo=algo, remat=remat,
                           cfg=cfg, **train_kw)[0]
    if shape.mode == "prefill":
        return trace_prefill(arch, shape, mesh, cfg=cfg)[0]
    return trace_decode(arch, shape, mesh, cfg=cfg)[0]


#: the extrapolated terms of a probe record
_TERMS = ("flops", "peak_bytes", "coll_bytes")


def probe_costs(arch, shape: InputShape, mesh=None, *, algo="ace",
                remat="full", cfg=None, **train_kw) -> Dict:
    """FLOPs, peak bytes and collective bytes per rank, traced at one and
    two repeats of each stage (and of the encoder) and extrapolated
    linearly to the full depth of `cfg` (default: the arch's bf16 config
    for `shape`), as JAX's probes are."""
    base_cfg = cfg or get_config(arch, shape=shape.name, dtype="bfloat16")
    n_stage = len(base_cfg.stages)
    reps_full = [r for _, r in base_cfg.stages]
    enc_full = base_cfg.num_encoder_layers if base_cfg.is_encoder_decoder \
        else 0

    def probe(reps, enc):
        return _trace(arch, shape, mesh, _with_reps(base_cfg, reps, enc),
                      algo, remat, **train_kw)

    p1 = probe([1] * n_stage, 1 if enc_full else 0)
    terms = {k: p1[k] for k in _TERMS}
    for s in range(n_stage):
        reps = [1] * n_stage
        reps[s] = 2
        p2 = probe(reps, 1 if enc_full else 0)
        for k in terms:
            terms[k] += (reps_full[s] - 1) * (p2[k] - p1[k])
    if enc_full:
        p2 = probe([1] * n_stage, 2)
        for k in terms:
            terms[k] += (enc_full - 1) * (p2[k] - p1[k])
    # linear extrapolation can go slightly negative on tiny terms — clamp
    return {k: max(v, 0.0) for k, v in terms.items()}


# ---------------------------------------------------------------------------
# One record
# ---------------------------------------------------------------------------

def argument_bytes(arch, shape: InputShape, mesh, *, algo="ace", cfg=None,
                   fsdp=True, cache_dtype=None):
    """``(spec bytes per rank, held bytes per rank, cfg)`` of a mode's
    arguments on the mesh of axis sizes `mesh`."""
    cfg = cfg or get_config(arch, shape=shape.name, dtype="bfloat16")
    sizes = axis_sizes(mesh)
    if shape.mode == "train":
        over = {"algorithm": algo}
        if cache_dtype:
            over["cache_dtype"] = cache_dtype
        args, specs = train_args(cfg, shape, afl_config(arch, **over),
                                 fsdp=fsdp, mesh=mesh)
    elif shape.mode == "prefill":
        args, specs = prefill_args(cfg, shape, mesh)
    else:
        args, specs = decode_args(cfg, shape, mesh)
    return tree_bytes(args, specs, sizes), tree_bytes(args), cfg


def run_one(arch: str, shape_name: str, *, multi_pod=False, algo="ace",
            remat="full", probes: bool = True, variant: str = "",
            cache_dtype: Optional[str] = None,
            probe_memo: Optional[Dict] = None) -> Dict:
    """One record. `probe_memo` (a dict) keeps each (arch, shape, algo,
    remat, cache dtype)'s probes for the next mesh: the traced step does
    not depend on the mesh, since the port replicates every argument."""
    shape = INPUT_SHAPES[shape_name]
    if not supports_shape(arch, shape_name):
        return {"arch": arch, "shape": shape_name, "multi_pod": multi_pod,
                "skipped": skip_reason(arch, shape_name)}
    mesh = production_mesh(multi_pod)
    chips = math.prod(mesh.values())
    t0 = time.time()
    spec_b, held_b, cfg = argument_bytes(arch, shape, mesh, algo=algo,
                                         cache_dtype=cache_dtype)
    rec = {
        "arch": arch, "shape": shape_name, "multi_pod": multi_pod,
        "mode": shape.mode, "algo": algo if shape.mode == "train" else None,
        "variant": variant, "chips": int(chips), "mesh": mesh,
        "trace_device": trace_device(), "hardware": HARDWARE,
        "spec_argument_bytes_per_rank": int(spec_b),
        "held_argument_bytes_per_rank": int(held_b),
        "params": cfg.param_count(),
        "active_params": cfg.active_param_count(),
        "tokens": shape.global_batch * (1 if shape.mode == "decode"
                                        else shape.seq_len),
    }
    over = {"algorithm": algo}
    if cache_dtype:
        over["cache_dtype"] = cache_dtype
    aflc = afl_config(arch, **over) if shape.mode == "train" else None
    ana = analytic_costs(cfg, shape, remat=remat, afl=aflc)
    rec["analytic_flops_total"] = ana["flops"]
    rec["analytic_bytes_total"] = ana["bytes"]
    if probes:
        key = (arch, shape_name, algo, remat, cache_dtype)
        pr = (probe_memo or {}).get(key)
        if pr is None:
            with fake_world(chips):
                pr = probe_costs(arch, shape, mesh, algo=algo, remat=remat,
                                 cache_dtype=cache_dtype)
            if probe_memo is not None:
                probe_memo[key] = pr
        rec["probe_flops_per_rank"] = pr["flops"]
        rec["peak_bytes_per_rank"] = pr["peak_bytes"]
        rec["probe_coll_per_rank"] = pr["coll_bytes"]
        rec["peak_path"] = "plain versions (backend='torch')"
    rec["trace_s"] = round(time.time() - t0, 1)

    # roofline terms (seconds a step, per rank): every rank computes the
    # whole step (replicated), so the port's terms divide the whole step's
    # analytic counts by one card; spec_* divide by the chips as JAX's
    # layout would
    peak = PEAK_FLOPS[cfg.dtype]
    rec.update({
        "peak_flops": peak, "hbm_bw": HBM_BW, "nvlink_bw": NVLINK_BW,
        "t_compute": ana["flops"] / peak,
        "t_memory": ana["bytes"] / HBM_BW,
        "t_collective": rec.get("probe_coll_per_rank", 0.0) / NVLINK_BW,
        "spec_t_compute": ana["flops"] / chips / peak,
        "spec_t_memory": ana["bytes"] / chips / HBM_BW,
    })
    terms = {"compute": rec["t_compute"], "memory": rec["t_memory"],
             "collective": rec["t_collective"]}
    rec["bottleneck"] = max(terms, key=terms.get)
    model_flops = 6 * rec["active_params"] * rec["tokens"]
    rec["model_flops"] = model_flops
    rec["useful_flop_ratio"] = (model_flops / ana["flops"]
                                if ana["flops"] else 0.0)
    held = max(rec["held_argument_bytes_per_rank"],
               rec.get("peak_bytes_per_rank", 0.0))
    rec["fits_one_card"] = held <= CARD_BYTES
    if not rec["fits_one_card"]:
        rec["fit_note"] = (f"holds {held / 1e9:.1f} GB per rank (arguments "
                           f"or peak) against the card's "
                           f"{CARD_BYTES / 1e9:.0f} GB: the port replicates "
                           f"what JAX's layout splits to "
                           f"{spec_b / 1e9:.2f} GB of arguments")
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="the port's production dry run over fake tensors")
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--algo", default="ace")
    ap.add_argument("--remat", default="full")
    ap.add_argument("--out", default="results/dryrun_torch.jsonl")
    ap.add_argument("--no-probes", action="store_true")
    args = ap.parse_args(argv)

    archs = list(ARCHS) if args.arch == "all" else args.arch.split(",")
    shapes = (list(INPUT_SHAPES) if args.shape == "all"
              else args.shape.split(","))
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    memo: Dict = {}
    with open(args.out, "a") as f:
        for arch in archs:
            for shape in shapes:
                for mp in meshes:
                    t0 = time.time()
                    try:
                        rec = run_one(arch, shape, multi_pod=mp,
                                      algo=args.algo, remat=args.remat,
                                      probes=not args.no_probes,
                                      probe_memo=memo)
                    except Exception as e:  # record failures, keep going
                        rec = {"arch": arch, "shape": shape, "multi_pod": mp,
                               "error": f"{type(e).__name__}: {e}"}
                    rec["wall_s"] = round(time.time() - t0, 1)
                    f.write(json.dumps(rec) + "\n")
                    f.flush()
                    status = ("SKIP" if rec.get("skipped") else
                              "FAIL" if rec.get("error") else "OK")
                    print(f"[{status}] {arch} {shape} mp={mp} "
                          f"({rec['wall_s']}s) {rec.get('error', '')}",
                          flush=True)


if __name__ == "__main__":
    main()
