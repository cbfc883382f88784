"""End-to-end AFL training driver on a real model — the port of
`repro.launch.train`.

Runs the paper's sampled-staleness protocol (Fig. 2) on a transformer of
`repro_torch.models`: client gradients are the model's own, the O(d)
incremental server rules (ACE, ACED, CA²FL, …) run in the staleness
engine's tick on the tree layout (tree caches over the parameters, int8
leaves through the quant kernels), and the (tau_max+1, ·) model-history
ring carries the stale reads (int8 with --history-dtype). Execution is
chunked (`make_chunked_staleness_runner`, the tick captured as a CUDA graph
on the card): every chunk boundary is a checkpoint and resume point holding
the whole protocol state — model, rule state with its caches and running
sums, history ring, the stream cursor ``e`` — so --ckpt-dir resumes where
the run stopped, server rule included, bit for bit.

The protocol's streams (gumbels and staleness, payload noise, the fault
schedule) are drawn up front from --seed on the run's device
(`build_staleness_randomness`, `build_payload_noise`,
`build_fault_schedule`); ``--driver host`` runs the host reference
`StalenessSimulator` on the same streams (within 1e-5 of the engine with
f32 caches).

Several devices: one process a rank, started by ``torchrun
--nproc-per-node N -m repro_torch.launch.train --mesh auto ...`` (the
driver joins the group torchrun describes: NCCL on the cards, one card a
rank; gloo with ``--device cpu``). ``--mesh auto`` then runs the sharded
chunked runner over `staleness_mesh()` (the tree layout keeps its state
replicated on every rank); rank 0 alone prints and writes checkpoints, and
every rank restores from the same file. One rank (or no group) runs
unsharded; one process that sees more than one card without a group
raises, naming torchrun.

Example (CPU, a ~0.8M-number yi-family model, 200 server iterations):
  PYTHONPATH=src python -m repro_torch.launch.train --arch yi-9b --reduced \\
      --steps 200 --batch 8 --seq 256 --algo ace --device cpu
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint import (restore_train_checkpoint,
                                    save_train_checkpoint)
from repro_torch.configs.registry import afl_config, get_config
from repro_torch.core.aggregators import make_aggregator
from repro_torch.core.fl_tasks import make_lm_task
from repro_torch.core.scan_engine import build_payload_noise, default_n_events
from repro_torch.core.scan_sharded import (
    make_sharded_chunked_staleness_runner, staleness_mesh)
from repro_torch.core.scan_staleness import (build_fault_schedule,
                                             build_staleness_randomness,
                                             make_chunked_staleness_runner)
from repro_torch.core.staleness_sim import StalenessSimulator, default_tau_max
from repro_torch.kernels.backend import resolve_device
from repro_torch.optim import sqrt_nt_schedule


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-9b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--steps", type=int, default=200,
                    help="server iterations T")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--vocab", type=int, default=512)
    ap.add_argument("--algo", default="ace")
    ap.add_argument("--n-clients", type=int, default=8)
    ap.add_argument("--lr-scale", type=float, default=0.5)
    ap.add_argument("--beta", type=float, default=5.0)
    ap.add_argument("--speed-skew", type=float, default=0.0)
    ap.add_argument("--driver", choices=("scan", "host"), default="scan",
                    help="scan: the chunked engine (default); host: the "
                    "host reference loop on the same streams")
    ap.add_argument("--chunk-events", type=int, default=64,
                    help="events per chunk (checkpoint granularity); need "
                    "not divide the event budget — the final chunk runs "
                    "partial")
    ap.add_argument("--k-batch", type=int, default=1,
                    help="arrivals consumed per server tick")
    ap.add_argument("--history-dtype", choices=("float32", "int8"),
                    default="float32",
                    help="model-history ring layout; int8 is ~4x smaller "
                    "but leaves the ≤1e-5 host-replay contract")
    ap.add_argument("--cache-dtype", choices=("float32", "bfloat16", "int8"),
                    default="float32",
                    help="aggregator cache dtype (f32 keeps the host replay "
                    "within 1e-5; int8 quantizes per leaf here and per "
                    "raveled row in the host reference)")
    ap.add_argument("--mesh", choices=("auto", "none"), default="auto",
                    help="auto: shard over a (data, model) mesh of the "
                    "process group's ranks (torchrun --nproc-per-node N); "
                    "unsharded on one rank")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100,
                    help="events between checkpoints (rounded to chunk "
                    "boundaries)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    # --- fault injection and the guard pipeline ---------------------------
    ap.add_argument("--clip-norm", type=float, default=0.0,
                    help="global-norm clip threshold for client payloads "
                    "(0 disables; >0 turns the guard pipeline on)")
    ap.add_argument("--fault-nan-rate", type=float, default=0.0,
                    help="fraction of events injected with NaN payloads "
                    "(quarantined by the guard pipeline)")
    ap.add_argument("--fault-explode-rate", type=float, default=0.0,
                    help="fraction of events with norm-exploded payloads")
    ap.add_argument("--fault-byzantine-rate", type=float, default=0.0,
                    help="fraction of events with sign-flipped payloads")
    ap.add_argument("--fault-overstale-rate", type=float, default=0.0,
                    help="fraction of events arriving with tau > tau_max "
                    "(rejected by the guard pipeline)")
    ap.add_argument("--fault-explode-scale", type=float, default=1e4,
                    help="norm multiplier for explode faults")
    ap.add_argument("--resync-every", type=int, default=0,
                    help="emitted updates between exact recomputes of the "
                    "incremental ACED/CA2FL running sums (0 disables)")
    ap.add_argument("--checkify", action="store_true",
                    help="put the repro_torch.core.sanitize checks in the "
                    "tick (finite model and payload, ring-cursor and "
                    "owner-ring bounds, resync agreement); equivalent to "
                    "REPRO_CHECKIFY=1. Off adds no op")
    ap.add_argument("--device", default=None,
                    help="the run's device (default: the GPU; 'cpu' runs "
                    "the kernels' plain versions)")
    return ap


def train(**overrides) -> float:
    """Programmatic entry point: the parser's defaults and keyword
    overrides (underscored option names, e.g. ``train(reduced=True,
    d_model=64, device="cpu")``)."""
    args = _parser().parse_args([])
    for k, v in overrides.items():
        if not hasattr(args, k):
            raise TypeError(f"unknown train option {k!r}")
        setattr(args, k, v)
    return _run(args)


def main(argv=None) -> float:
    return _run(_parser().parse_args(argv))


def _join_group(device: torch.device) -> torch.device:
    """Join the process group torchrun describes (``WORLD_SIZE`` > 1 in the
    environment) unless one is initialised: NCCL with one card a rank
    (``LOCAL_RANK``), gloo on the CPU. Returns the rank's device."""
    if dist.is_initialized() or int(os.environ.get("WORLD_SIZE", "1")) < 2:
        return device
    if device.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        dist.init_process_group("nccl")
        return torch.device("cuda", torch.cuda.current_device())
    dist.init_process_group("gloo")
    return device


def _mesh(mode: str, device: torch.device):
    """``--mesh auto``: `staleness_mesh()` over the process group's ranks
    (None on one rank, as JAX's is on one device). Without a group, one
    process that sees more than one card raises: it never runs unsharded
    over them by itself."""
    if mode != "auto":
        return None
    if not dist.is_initialized():
        visible = torch.cuda.device_count() if device.type == "cuda" else 1
        if visible > 1:
            raise RuntimeError(
                f"--mesh auto sees {visible} cards in one process: start one "
                f"process a card with `torchrun --nproc-per-node {visible} "
                "-m repro_torch.launch.train --mesh auto ...`, or pass "
                "--mesh none (or expose one card) to run on one")
        return None
    return staleness_mesh()


def _run(args) -> float:
    device = _join_group(resolve_device(args.device))
    mesh = _mesh(args.mesh, device)
    # rank 0 alone prints and writes checkpoints
    lead = mesh is None or dist.get_rank() == 0
    say = print if lead else (lambda *a, **k: None)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced(layers=args.layers, d_model=args.d_model,
                          vocab=args.vocab)
    aflc = afl_config(args.arch, algorithm=args.algo,
                      n_clients=args.n_clients, delay_beta=args.beta,
                      cache_dtype=args.cache_dtype, k_batch=args.k_batch)
    say(f"model={cfg.name} params={cfg.param_count()/1e6:.1f}M "
        f"algo={args.algo} clients={aflc.n_clients} driver={args.driver} "
        f"device={device}")

    agg = make_aggregator(aflc)
    task = make_lm_task(cfg=cfg, n_clients=aflc.n_clients, batch=args.batch,
                        seq=args.seq, seed=args.seed, device=device)
    T = args.steps
    server_lr = sqrt_nt_schedule(args.lr_scale, aflc.n_clients, T)
    tau_max = default_tau_max(args.beta)
    fault_rates = {"nan_rate": args.fault_nan_rate,
                   "explode_rate": args.fault_explode_rate,
                   "byzantine_rate": args.fault_byzantine_rate,
                   "overstale_rate": args.fault_overstale_rate}
    any_faults = any(r > 0 for r in fault_rates.values())
    guards = any_faults or args.clip_norm > 0
    n_events = default_n_events(agg, T, True)
    if any_faults:
        # quarantined and rejected events never emit: pad the budget so the
        # run still reaches T server iterations in expectation
        drop = args.fault_nan_rate + args.fault_overstale_rate
        n_events = int(np.ceil(n_events / max(1.0 - drop, 0.5))) + 16
    C = max(1, args.chunk_events)
    # the exact event budget: the final chunk runs partial, so the
    # checkpointed cursor never claims events past the streams, and a
    # resume with another --chunk-events reads the same streams
    rand = build_staleness_randomness(args.seed, n_events, aflc.n_clients,
                                      args.beta, speed_skew=args.speed_skew,
                                      k_batch=args.k_batch, device=device)
    noise = build_payload_noise(task.grad_fn, args.seed, n_events,
                                aflc.n_clients, k_batch=args.k_batch,
                                device=device)
    faults = None
    if guards:
        faults = build_fault_schedule(
            args.seed, n_events, explode_scale=args.fault_explode_scale,
            k_batch=args.k_batch, device=device, **fault_rates)
        say(f"guards on: clip_norm={args.clip_norm} "
            f"resync_every={args.resync_every or 'off'} "
            f"injected={faults.counts()}")
    resync_every = args.resync_every or None

    if args.driver == "host":
        sim = StalenessSimulator(
            grad_fn=task.grad_fn, params0=task.params0, aggregator=agg,
            n_clients=aflc.n_clients, server_lr=server_lr, beta=args.beta,
            tau_max=tau_max, speed_skew=args.speed_skew, seed=args.seed,
            replay=rand, payload_noise=noise, faults=faults,
            clip_norm=args.clip_norm, resync_every=resync_every,
            k_batch=args.k_batch, device=device)
        res = sim.run(T)
        final = float(np.mean(res.losses[-20:]))
        if res.faults:
            say(f"guard counters: {res.faults}")
        say(f"final loss (mean last 20): {final:.4f}")
        return final

    kw = dict(
        capacity=C, grad_fn=task.grad_fn, params0=task.params0,
        aggregator=agg, n_clients=aflc.n_clients, T=T, beta=args.beta,
        server_lr=server_lr, tau_max=tau_max, speed_skew=args.speed_skew,
        layout="tree", history_dtype=args.history_dtype, guards=guards,
        resync_every=resync_every, checkify_invariants=args.checkify or None,
        k_batch=args.k_batch, device=device)
    runner = (make_chunked_staleness_runner(**kw) if mesh is None
              else make_sharded_chunked_staleness_runner(mesh=mesh, **kw))

    lr0 = 0.0                 # the schedule is baked in; the runtime lr unused
    carry = runner.init(lr0, noise.init)
    e0 = 0
    if args.ckpt_dir:
        carry, e0 = restore_train_checkpoint(args.ckpt_dir, carry)
        if int(carry["e"]) != e0:
            raise RuntimeError(f"checkpoint at event {e0} holds a carry at "
                               f"event {int(carry['e'])}")
        if e0:
            say(f"resumed from event {e0} (t={int(carry['t'])})")
        e0 = min(e0, n_events)
        if mesh is not None:
            dist.barrier()      # every rank has read before rank 0 writes

    losses: list = []
    t0 = time.time()
    events_done, last_log = 0, 0
    for lo in range(e0, n_events, C):
        hi = min(lo + C, n_events)
        guard_args = ()
        if guards:
            guard_args = (faults.slice(lo, hi), args.clip_norm)
        # the new carry replaces the old one at once: no third copy stays
        carry, outs = runner.chunk(carry, rand.slice(lo, hi),
                                   noise.ticks[lo:hi], lr0, *guard_args)
        em = outs["emit"].cpu().numpy()
        losses.extend(outs["loss"].cpu().numpy()[em].tolist())
        events_done += hi - lo
        t_now = int(carry["t"])
        if len(losses) - last_log >= args.log_every or hi >= n_events:
            last_log = len(losses)
            dt = time.time() - t0
            say(f"t={t_now:5d}/{T} events={hi} "
                f"loss={np.mean(losses[-args.log_every:]):.4f} "
                f"({events_done * args.k_batch / max(dt, 1e-9):.1f} ev/s)",
                flush=True)
        if args.ckpt_dir and lead and (
                hi // args.ckpt_every != lo // args.ckpt_every
                or hi >= n_events or t_now >= T):
            save_train_checkpoint(args.ckpt_dir, hi, carry)
        if t_now >= T:
            break

    ev = task.eval_fn(carry["w"])
    if guards:
        counters = {k: int(v) for k, v in carry["guards"].items()}
        say(f"guard counters: {counters}")
    # resumed past the event budget: no fresh losses, report the eval loss
    final = float(np.mean(losses[-20:])) if losses else ev["loss"]
    say(f"final loss (mean last 20): {final:.4f}  eval={ev}")
    return final


if __name__ == "__main__":
    main()
