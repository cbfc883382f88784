#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises, and the script exits non-zero without a
result line):
  1. the card's name and power limit, from nvidia-smi;
  2. build the hand-written kernels from src/repro_torch/kernels/csrc with
     nvcc for sm_90a (one process per source, all at once);
  3. each kernel against its plain PyTorch version on the card, at the
     main path's shapes and at a large width: int8 rows and scales
     bit-identical, f32 outputs within 1e-6 of the output's scale.
     the fused int8 row swap row_delta (new scale, gather, swap and
     scatter in one launch) on a 4-row cache at d = 17,226 and 2^24 + 3:
     every row and scale, delta and old bit-identical, the other rows
     untouched, a payload holding a NaN, +inf or -inf coded 0, timed beside
     the device time and device launches of the whole
     FlatCache.set_row_delta call; the whole int8 ACE step
     cache_row_update (new scale, row swap and u' in one launch) the same
     way for f32 and bf16 states, u' bit-identical and the input u
     untouched, timed beside the whole ACEIncremental.step call;
     commit_batch (K = 16, R = 1, 2, 3) with int8 and with f32 cache rows,
     NaN-poisoned invalid lanes and an all-invalid batch, also at d = 128,
     d = 130 and K = 17, each timing row beside the device time of the
     whole `ops.commit_batch` call and its device launches per call;
     masked_agg at (n, d) = (100, 17,226) and (100, 2^22 + 3) with random,
     all-true and all-false masks; quantize_rows at (1, 17,226),
     (100, 17,226) and (100, 2^22 + 3) with an all-zero row and a row of
     half-way ties, x also at offsets of 4, 8 and 12 bytes;
     dequantize_rows at (100, 17,226) and (100, 2^22 + 3), q also at
     offsets of 1-3, 4, 8 and 12 bytes; both also at (1, 17,227) and
     (2, 7), untimed, and each prints its launch plan; row_delta,
     cache_row_update and quantize_rows (1, d) also at the text task's
     d = 70,996, the row kernels there on their cooperative grid;
     quantize_rows also at (1, 131,072), (1, 2,097,152) and
     (1, 2^24 + 3), the last two on its cooperative grid, each quantize_rows
     shape timed on the other kind of plan too (grid or cluster) and
     beside its two-pass floor (9 B a number); a traced grid launch, cluster
     launch and dequantize_rows launch, each counted as its own kernel's
     by the traces' name matching. Each is timed
     beside its bound and its plain version, and dequantize_rows beside
     `torch.mul(q, s[:, None])`, the one PyTorch call that computes it (no
     single call computes the other five: their library_ms is null);
  4. the main path: the engine's runner (`make_staleness_runner`, what
     `run_staleness_scan` runs) on the vision task at full width (n = 100
     clients, d = 17,226), the tick captured as one CUDA graph and replayed
     once per tick, with the launch counts zeroed just before each run and
     read just after (replayed launches included) — ACE, ACED and CA²FL
     with an int8 cache at K = 1 and K = 16 and an f32 cache at K = 1 and
     16; ASGD, delay-adaptive ASGD and FedBuff (buffer 10) at K = 1 and
     K = 16; the direct ACE, ACED and CA²FL rules with int8 and f32 caches
     at K = 1. Each rule's kernels must have been launched, the final model
     finite and its test accuracy above 0.5 (chance is 0.1), and each run
     is repeated with the eager tick (graph=False): model, cache rows and
     scales, every state tensor and every per-event output bit-identical.
     The int8 K = 16 ACE run and the int8 direct ACED run are repeated
     eagerly through the plain versions on the card and must end within
     1e-4 of the kernels' runs; each incremental rule's final model is set
     beside its direct reference's (int8 and f32, K = 1, same seed). int8
     ACE at K = 16 and int8 ACE, ACED, ACED-direct and ACE-direct at K = 1
     are timed untraced eager, graph, graph, eager (wall ms per tick and
     arrivals/s), and one traced graph run each gives the device's busy
     time, idle share, device kernels per tick, its largest kernels and
     the port's kernels seen in the replays, each seen as many times as
     its launch counter counted in that run (the captured tick's counts ×
     replays, plus the init's eager launches);
  4b. faults, guards, resync and sweeps on the same task and width, the
     launch counts zeroed before each run and added to the totals after:
     six faulted configurations (rates of 0.05 for NaN, exploding,
     Byzantine and over-stale clients, the clip at the median payload norm
     at w0) — ACE, ACED and CA²FL int8 K = 1, ACE int8 K = 16, ACED f32
     K = 16, ACED-direct int8 — each graph run bit-identical to its eager
     run (the guard counters and flags included), every guard fired, the
     model finite and accuracy above 0.5; guards on a clean schedule with
     the clip off (ACE int8 K = 1 and 16) bit-identical to phase 4's
     guards-off runs; faulted ACED and CA²FL int8 K = 1 with resync every
     10th update, graph = eager, the final running sums within 1e-4
     (relative) of a fresh resync; a 3 × 2 lr × seed grid of int8 ACE
     K = 1 on one capture, every cell bit-identical to its
     run_staleness_scan, timed against those six runs (six captures) in
     turns; a faulted seed sweep of int8 ACED K = 1 (counts per seed);
     then guards off against on (ACE and ACED int8 K = 1, ACE int8 K = 16)
     and resync against none (ACED int8 K = 1) in turns, each traced;
  4c. the text task, the event engine and the sanitize checks, the launch
     counts added to the totals: the text task at its defaults (n = 20,
     d = 70,996, lr = 3·√(n/T)) for ACE, ACED and CA²FL (buffer 10, T =
     30) with int8 and f32 caches at K = 1, int8 at K = 16, and ASGD, each
     graph run bit-identical to its eager run, its kernels launched (int8
     ACE K = 1: cache_row_update on its grid plan, printed), accuracy above
     0.10 (chance 0.05), int8 ACE K = 16 eagerly twice bit for bit (the
     embedding gradient) and int8 ACE K = 1 through the plain versions
     within 1e-4; the event engine (`make_scan_runner`) on the vision task
     at full width (κ = 4, β = 5, T = 300, concurrency n) for ACE int8 and
     f32, ACED, CA²FL and ACED-direct int8 and ASGD, graph = eager (t_recv
     and w_recv too), accuracy above 0.12 (chance 0.1), and a seed sweep
     on one capture equal to each seed's run_scan; three text and two event
     configurations timed eager, graph, graph, eager, and all but the text
     K = 16 run traced (its trace crashed the profiler); then the
     sanitize checks on int8 ACED K = 1: on bit-identical to off, off's
     device kernels a tick phase 4's, off against on in turns and traced, a
     NaN params0 raising "non-finite server model" and a chunk whose carry
     holds an owner-ring slot of 9999 raising "owner-ring slot out of
     bounds" with no device assert;
  4d. the host references on the same task and width (T = 100, seed 0's
     streams), the launch counts added to the totals: `StalenessSimulator`
     in replay mode against the graph runner on the same streams — ACE,
     ACED, ACED-direct int8 K = 1, CA²FL int8 K = 16 and ACE int8 K = 16
     with the fault study's schedule, the clip and resync every 10 — and
     `AFLSimulator` against the event engine's graph runner (β = 5, κ = 4,
     concurrency n) for ACE and ACED int8: the final models within 1e-5,
     `ts`, uploads and guard counters identical, losses and update norms
     within rtol 1e-4, each host run's kernels (and the int8 init's
     quantize_rows) launched, whether each pair is bit-identical printed,
     and wall ms a tick of the host run beside the graph run's (cold and
     warm) and the eager tick's; then examples/torch_quickstart.py through
     its `main` on the card: 319 and 300 uploads, finite models, final
     accuracies above 0.5;
  4e. the tree layout (``layout="tree"``: the model as the MLP's list of
     six leaves, tree caches, the history ring a tree cache) on the same
     task and width (300 ticks, seed 0's streams), the launch counts added
     to the totals: ACE, ACED and CA²FL with int8 and f32 caches at K = 1
     (each f32 run's final model within 1e-5 of phase 4's flat run), int8
     ACE at K = 16, int8 ACE with an int8 history ring, int8 ACED faulted
     with the clip and resync every 10 (every guard fired, its counters
     beside phase 4b's flat run's) and the text task's int8 ACE K = 1 (the
     1024 × 64 embedding a leaf; accuracy above 0.10); each graph run
     bit-identical to its eager run (model and caches leaf by leaf), every
     int8 run's quantize_rows and dequantize_rows launched, accuracy above
     0.5; int8 ACE and ACED K = 1 timed eager, graph, graph, eager and
     traced (both kernels seen in the replays as often as their counters
     count), wall ms and device kernels a tick printed beside phase 4's
     flat runs;
  4f. the real models: yi-9b at its published widths (d_model 4,096, 32
     heads, 4 kv heads, d_ff 11,008, vocab 64,000) cut to one layer (11
     leaves, 435,171,328 numbers), on the LM task at n = 8 clients, batch
     8, seq 256 through the tree layout with int8 tree caches and an int8
     history ring (51 rows), 12 ticks at lr 0.1, the launch counts added
     to the totals: (a) the leaf count and numel, the eval loss at w0
     within 0.5 of ln 64,000, a prefill of 16 tokens carried into a
     decode cache and 16 decode steps against the forward pass within
     3e-3; (d) quantize_rows and dequantize_rows bit for bit with their
     plain versions at every leaf numel by 1 and 8 rows, quantize_rows
     timed (CUDA events, 5 calls) at each of those views of 2^20 numbers
     or more (its grid) beside the cluster plan, its bound, two-pass floor
     and plain version, dequantize_rows at the embedding's row,
     (1, 262,144,000); (b) ACE int8 K = 1 and ACED int8 K = 3, each graph
     run bit for bit with its eager
     run, finite, both quant kernels launched, eval losses and peak memory
     printed; (c) ACE again with the plain versions (no launch, within
     1e-4); (e) ACE timed eager, graph, graph, eager and one graph run
     traced (device kernels and busy ms a tick, idle share, the matrix
     products', the embedding backward's and the quant kernels' share);
  4g. the rest of the real models: zamba2-1.2b at its published widths
     (d_model 2,048, 32 heads and kv heads of 64, d_ff 8,192, ssm_state 64,
     d_inner 4,096, conv 4, chunk 256, window 4,096, vocab 32,000) cut from
     38 layers to 7 — one (mamba ×5, shared_attn) unit and one (mamba,)
     stage, the shared block at model level: 65 leaves, 286,169,984
     numbers — on the LM task at 4f's settings, with 4f's gates (a)-(e)
     (decode from init_cache: an SSM's prefill keeps no state), and
     ssd_chunked's forward and backward timed at a lane's shapes against
     the traced tick; then at the published widths, one model at a time:
     mamba2-780m (all 48 layers) decode against forward over 32 tokens and
     ssd_chunked at its head shapes (H 48, P 64, N 128) over two chunks
     against the step recurrence, qwen3-moe-235b-a22b at one layer (two
     gradients of one batch bit for bit; decode against forward at
     capacity factor 16, that comparison only) and seamless-m4t-medium at
     full depth (forward, loss and three decode steps finite);
  4h. the train stack, the launch counts added to the totals: (a) the
     serving driver `repro_torch.launch.serve.main([])` at its defaults —
     gemma2-2b at its published size, all 26 layers (2,614,222,080
     numbers), batch 4, a prompt of 64, 32 generated — twice: (4, 32)
     tokens in range, the same both times; `generate` on the same weights
     and prompts timed (prefill alone, then with generation), its tokens
     main's, the last prompt step's logits within 3e-3 of the forward pass
     (4f's gate), decode FLOP/s from `launch.analytic.decode_flops`, 8
     decode steps traced (kernels and busy ms a step, idle share); then
     examples/torch_serve_batch.py; (b) the AFL train step
     (`core.distributed.make_afl_train_step`, sgd(0.1)) at yi-9b's widths,
     one layer (4f's cut), n = 8 clients, int8 tree caches, ACE and ACED:
     8 steps of batch 8 × seq 256 from the LM task's token stream, clients
     in turn, staleness from the port's stream; both quant kernels
     launched, the parameters finite, the same 8 steps through the plain
     versions (``backend="torch"``) within 1e-4 (relative); ms a step,
     peak memory, FLOP/s against 3 × `analytic.forward_flops`; (c) the
     train driver `repro_torch.launch.train.main` at
     tests/test_system.py's reduced sizes (gemma2, 2 layers, d_model 128,
     vocab 256, seq 64, batch 8, 120 steps, ACE, an int8 cache,
     checkpoints every 60 events in a temporary directory the phase
     removes): final loss below 5.75; the straight run's directory with
     only its checkpoint before the last resumed, and with its newest
     checkpoint truncated to half (a warning, the fallback), each final
     checkpoint bit for bit the straight run's; ``--driver host`` against
     the engine with f32 caches within 1e-5; a faulted run (NaN rate
     0.05, the clip at 1.0, resync every 10) and its guard counters;
     examples/torch_train_lm.py runs 100 steps (its exit code is its
     loss bound's, as its JAX twin's: ROADMAP §C, C15);
  4i. the sharded runner (`make_sharded_staleness_runner`) over an NCCL
     group of one rank initialised in-process, on `make_host_mesh()`'s
     (1, 1) mesh: every block collective still runs on its group and is
     captured in the tick's graph. ACE, ACED and ACED-direct int8 K = 1,
     CA²FL int8 K = 16 and ACE f32 K = 1 at phase 4's widths and streams:
     each final model within 1e-5 of phase 4's unsharded graph run (max
     |diff| printed, and whether bit for bit), a capture each, each rule's
     kernel launched and all six over the phase; graph ms a tick sharded
     against unsharded in turns, and a traced sharded run of int8 ACE
     K = 1 and CA²FL K = 16 (device kernels a tick, the NCCL kernels'
     ms a tick); at most 60 s;
  4j. the dry run over fake tensors (`repro_torch.launch.dryrun`) against
     the card at 4h (b)'s cut (yi-9b's widths, one layer, n = 8, int8 tree
     caches, one step of batch 8 × seq 256, ACE and ACED): (a) its FLOPs
     equal FlopCounterMode's count of the real step, plain and kernel
     paths; (b) its peak (the plain versions' step) within 20% of the
     plain step's max_memory_allocated, the kernels' peak printed beside
     it; (c) one production record (yi-9b, train_4k, single pod) printed;
     at most 30 s;
  4k. the model laid out by the specs (`repro_torch.sharding.place`,
     DTensors) over an NCCL group of one rank on the (1, 1) mesh of
     `make_host_mesh`: (a) the AFL train step at 4h (b)'s cut (yi-9b's
     widths, one layer, n = 8, int8 tree caches, batch 8 × seq 256), ACE
     and ACED, placed by `place_train` against unplaced, in turns
     (unplaced, placed, placed, unplaced): the new parameters and losses
     bit for bit (max |diff| printed), both quant kernels launched inside
     the placed steps, ms a step each way (DTensor's host overhead);
     (b) gemma2-2b at its published size (4h's served model), eight
     `decode_step`s placed by `place_decode` against unplaced: the argmax
     tokens equal, max |diff| of the logits and ms a step printed; (c)
     zamba2-1.2b at 4g's cut (the SSD's heads and the shared block): ACE
     int8 train steps over 2 clients as (a), the placed state saved and
     restored bit for bit, eight decode steps as (b); (d)
     qwen3-moe-235b-a22b at one layer (the MoE's experts): loss and
     gradient at B = 2, L = 16 bit for bit, eight decode steps as (b) at
     capacity factor `MOE_DECODE_CAPACITY`; (e) seamless-m4t-medium at
     full depth (the cross-attention): the loss and three decode steps bit
     for bit; each run's seconds printed; at most 65 s;
  5. one JSON line of per-kernel numbers, then the result line.

Needs one GPU; imports nothing of JAX.
"""
from __future__ import annotations

import contextlib
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
D_TEXT = 70996                   # the text task's width (row kernels: grid)
# quantize_rows' grid (one row each; ROADMAP B item 2's untimed sizes)
D_QUANT_GRID = (131072, 2097152, D_LARGE)
# quantize_rows' ms (CUDA events) at the embedding rows on the cluster plan
# they had before the grid, as PERF.md §6 rows 5a'' and 5a''' keep them
CLUSTER_MS = {(1, 262144000): 5.92841, (1, 65536000): 1.50319}
LEAF_ITERS = 5                   # timed calls at a real model's leaf views
N_SLICE, D_ROWS_LARGE = 100, (1 << 22) + 3      # (n, d) of the cache-wide kernels

KERNELS = {
    # name: (source, TPU kernel it replaces)
    "row_delta": ("src/repro_torch/kernels/csrc/row_delta.cu",
                  "src/repro/kernels/row_delta.py:66"),
    "cache_row_update": ("src/repro_torch/kernels/csrc/cache_update.cu",
                         "src/repro/kernels/cache_update.py:67"),
    "commit_batch": ("src/repro_torch/kernels/csrc/commit_batch.cu",
                     "src/repro/kernels/commit_batch.py:116"),
    "masked_agg": ("src/repro_torch/kernels/csrc/masked_agg.cu",
                   "src/repro/kernels/masked_agg.py:46"),
    # one launch for both TPU phases: the |max| call at :53, quantize at :62
    "quantize_rows": ("src/repro_torch/kernels/csrc/quant.cu",
                      "src/repro/kernels/quant.py:53"),
    "dequantize_rows": ("src/repro_torch/kernels/csrc/quant.cu",
                        "src/repro/kernels/quant.py:83"),
}
ALSO_REPLACES = {"quantize_rows": "src/repro/kernels/quant.py:62"}
# the CUDA functions each kernel's launches carry in a profiler trace, as a
# pattern matched where a name starts (`symbol_matches`): quantize_rows'
# cluster and grid kernels, never dequantize_rows_kernel
KERNEL_SYMBOLS = {"row_delta": "row_delta",
                  "cache_row_update": "cache_update",
                  "commit_batch": "commit_batch_kernel",
                  "masked_agg": "masked_agg_kernel",
                  "quantize_rows": "quantize_rows_(?:grid_)?kernel",
                  "dequantize_rows": "dequantize_rows_kernel"}
RULE_LANES = {1: (), 2: ("a", "b"), 3: ("a", "g")}   # ACE, ACED, CA²FL


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


# --- timing -----------------------------------------------------------------

def symbol_matches(symbol, name):
    """Whether a kernel `name` in a trace is one of `symbol`'s (a pattern
    of `KERNEL_SYMBOLS`): the pattern where a name starts, so that
    "quantize_rows_kernel" never counts a dequantize_rows_kernel."""
    return re.search(r"(?<![A-Za-z_])" + symbol, name) is not None


def _device_us(torch, prof, name_part, launches=False):
    """Device time (µs) in a profile, or with `launches` the number of
    device events: of the kernels `name_part` matches (`symbol_matches`),
    or of every kernel when it is None. Only the device-side events count
    (a CPU op's own device time is its kernels' again)."""
    total = 0.0
    for e in device_kernels(torch, prof):
        if name_part is None or symbol_matches(name_part, e.key):
            total += e.count if launches else e.self_device_time_total
    return total


def measure(torch, fn, iters, kernel_name=None):
    """(device ms per call, event ms per call, device launches per call).
    Device time comes from torch.profiler's CUDA trace: the named kernel's
    own time, or all the call's kernels for the plain version; None when
    the profiler saw no device time. Event time is CUDA events around
    `iters` back-to-back calls (what a caller pays, host overhead
    included)."""
    for _ in range(2):
        fn()
    event_ms = _event_ms(torch, fn, iters)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    dev_us = _device_us(torch, prof, kernel_name)
    n = _device_us(torch, prof, kernel_name, launches=True) / iters
    return (dev_us / 1e3 / iters if dev_us > 0 else None), event_ms, n


# --- phase 3: kernels against their plain versions -----------------------------

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


def _same(torch, a, b):
    """Bit for bit, a NaN matching a NaN (its payload bits may differ
    between a kernel and PyTorch's ops)."""
    nan = torch.isnan(a)
    return bool(torch.equal(nan, torch.isnan(b)) and torch.equal(
        torch.where(nan, 0.0, a), torch.where(nan, 0.0, b)))


def compare_swap(torch, ops, d, dev, card):
    """The fused int8 row swap (ops.row_delta) against its plain version at
    d, on row 1 of a 4-row cache (2-byte aligned at an even d ≡ 2 mod 4):
    every row and scale, delta and old bit for bit, the other rows
    untouched; payloads holding a NaN, +inf or -inf must code the row 0.
    Timed as the kernel and as the whole FlatCache.set_row_delta call
    (device time and device launches per call). Returns (max abs f32
    error, timing row)."""
    from repro_torch.core.cache import FlatCache
    from repro_torch.kernels import ref
    n, j = 4, 1
    g = torch.Generator(device=dev).manual_seed(d % 1000)
    data, scale = ref.quantize_rows_ref(
        torch.randn(n, d, generator=g, device=dev) * 3)
    row = torch.tensor([j], device=dev)
    others = torch.arange(n, device=dev) != j
    x = torch.randn(d, generator=g, device=dev) * 5
    tag = f"row_delta d={d}"
    err = 0.0
    for label, val in (("random", None), ("NaN", float("nan")),
                       ("+inf", float("inf")), ("-inf", -float("inf"))):
        p = x.clone()
        if val is not None:
            p[d // 3] = val
        d1, s1, d2, s2 = data.clone(), scale.clone(), data.clone(), \
            scale.clone()
        delta1, old1 = ops.row_delta(d1, s1, row, p)
        delta2, old2 = ops.row_delta(d2, s2, row, p, backend="torch")
        torch.cuda.synchronize()
        check(torch.equal(d1, d2), f"{tag} {label}: int8 rows differ")
        check(torch.equal(d1[others], data[others]) and
              torch.equal(s1[others], scale[others]),
              f"{tag} {label}: another row changed")
        check(_same(torch, s1, s2), f"{tag} {label}: scales differ")
        check(_same(torch, delta1, delta2) and _same(torch, old1, old2),
              f"{tag} {label}: delta or old differs from plain")
        if val is not None:
            check(not bool(d1[j].any()), f"{tag} {label}: codes not 0")
        else:
            err = max(_err(torch, delta1, delta2)[0],
                      _err(torch, old1, old2)[0])
    print(f"kernel {tag}: int8 rows, scales, delta and old bit-identical, "
          f"other rows untouched, NaN/+inf/-inf rows coded 0, max_abs_err "
          f"{err:.3e} [{card}]")
    iters = 200 if d < 1e6 else 20
    call = lambda backend=None: ops.row_delta(data, scale, row, x,
                                              backend=backend)
    # per feature: g and the old code read, the new code, delta and old
    # written; the index, the old scale and the new scale
    # "row_delta" names both of its kernels: the cluster's and the grid's
    timing = _timing_row(torch, tag, call, "row_delta", 14 * d + 16, 8 * d,
                         iters, card)
    cache = FlatCache(data, scale)
    for backend in (None, "torch"):
        call_ms, _, per_call = measure(
            torch, lambda: cache.set_row_delta(row, x, backend=backend),
            iters if backend is None else max(5, iters // 10))
        print(f"kernel {tag}: whole FlatCache.set_row_delta call"
              f"{' (plain versions)' if backend else ''} {_fmt(call_ms)} ms "
              f"device, {per_call:g} device launches per call [{card}]")
    return err, timing


def compare_ace(torch, ops, d, dev, card):
    """The whole int8 ACE step (ops.cache_row_update) against its plain
    version at d, on row 2 of a 4-row cache (4-byte aligned at an even d),
    for an f32 and a bf16 state: every row and scale and u' bit for bit, u'
    in the state's dtype, the other rows and the input u untouched;
    payloads holding a NaN, +inf or -inf must code the row 0. Timed (f32
    state) as the kernel and as the whole ACEIncremental.step call, kernel
    against plain versions (device time and device launches per call).
    Returns (max abs error of u', timing row)."""
    from repro_torch.core.aggregators import ACEIncremental, Arrival
    from repro_torch.core.cache import FlatCache
    from repro_torch.kernels import ref
    n, j, inv_n = 4, 2, 1.0 / 4
    g = torch.Generator(device=dev).manual_seed(d % 1000 + 1)
    data, scale = ref.quantize_rows_ref(
        torch.randn(n, d, generator=g, device=dev) * 3)
    row = torch.tensor([j], device=dev)
    others = torch.arange(n, device=dev) != j
    x = torch.randn(d, generator=g, device=dev) * 5
    u32 = torch.randn(d, generator=g, device=dev)
    tag = f"cache_row_update d={d}"
    err = 0.0
    for u in (u32, u32.to(torch.bfloat16)):
        u_in = u.clone()
        for label, val in (("random", None), ("NaN", float("nan")),
                           ("+inf", float("inf")), ("-inf", -float("inf"))):
            p = x.clone()
            if val is not None:
                p[d // 3] = val
            d1, s1, d2, s2 = data.clone(), scale.clone(), data.clone(), \
                scale.clone()
            u1 = ops.cache_row_update(d1, s1, row, p, u, inv_n)
            u2 = ops.cache_row_update(d2, s2, row, p, u, inv_n,
                                      backend="torch")
            torch.cuda.synchronize()
            at = f"{tag} {u.dtype} state {label}"
            check(torch.equal(d1, d2), f"{at}: int8 rows differ")
            check(torch.equal(d1[others], data[others]) and
                  torch.equal(s1[others], scale[others]),
                  f"{at}: another row changed")
            check(_same(torch, s1, s2), f"{at}: scales differ")
            check(u1.dtype == u.dtype and _same(torch, u1.float(),
                                                u2.float()),
                  f"{at}: u' differs from plain")
            check(torch.equal(u, u_in), f"{at}: the input u was written")
            if val is not None:
                check(not bool(d1[j].any()), f"{at}: codes not 0")
            else:
                err = max(err, _err(torch, u1.float(), u2.float())[0])
    print(f"kernel {tag}: int8 rows, scales and u' bit-identical for f32 and "
          f"bf16 states, other rows and the input u untouched, "
          f"NaN/+inf/-inf rows coded 0, max_abs_err {err:.3e} [{card}]")
    iters = 200 if d < 1e6 else 20
    call = lambda backend=None: ops.cache_row_update(
        data, scale, row, x, u32, inv_n, backend=backend)
    # per feature: g, u and the old code read, the new code and u' written;
    # the index, the old scale and the new scale. "cache_update" names both
    # of its kernels: the cluster's and the grid's
    timing = _timing_row(torch, tag, call, "cache_update", 14 * d + 16,
                         10 * d, iters, card)
    state = {"cache": FlatCache(data, scale), "u": u32}
    arr = Arrival(row, x, 1, 0)
    for backend in (None, "torch"):
        agg = ACEIncremental(cache_dtype="int8", backend=backend)
        call_ms, _, per_call = measure(
            torch, lambda: agg.step(state, arr),
            iters if backend is None else max(5, iters // 10))
        print(f"kernel {tag}: whole ACEIncremental.step call"
              f"{' (plain versions)' if backend else ''} {_fmt(call_ms)} ms "
              f"device, {per_call:g} device launches per call [{card}]")
    return err, timing


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
    print(f"kernel {tag}: {rows} rows identical, max_abs_err {err:.3e} "
          f"(tolerance {F32_TOL:g} of the output's scale) [{card}]")
    n_l = len(lanes)
    row_b = kw["old_rows"].element_size()
    # every operand read once, every output written once: the (K, d) rows
    # and payloads, V in and out, the update, and the lane scalars (scales,
    # the bool mask, the lane weights) and the recombination matrix
    scales = 8 * K if rows == "int8" else 0
    nbytes = d * (K * (4 + 2 * row_b) + 2 * R * 4 + 4) + scales + K + (
        4 * (n_l * K + (R + 1) * (R + 4)))
    per_lane = 8 if rows == "int8" else 2    # dequant, quant, delta / delta
    nops = d * (K * (per_lane + 2 * n_l) + 2 * (R + 1) * (R + 1 + n_l))
    call = lambda backend=None: ops.commit_batch(**kw, backend=backend)
    iters = 200 if d < 1e6 else 10
    row = _timing_row(torch, tag, call, "commit_batch_kernel", nbytes, nops,
                      iters, card)
    # the whole ops.commit_batch call: every kernel it puts on the card
    call_ms, _, per_call = measure(torch, call, iters, kernel_name=None)
    print(f"kernel {tag}: whole ops.commit_batch call {_fmt(call_ms)} ms "
          f"device, {per_call:g} device launches per call [{card}]")
    return err, row


def _event_ms(torch, fn, iters):
    """CUDA-event ms per call over `iters` back-to-back calls, after one."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _timed(torch, fn, iters, kernel_name, bound):
    """(ms, source): the profiler's device time per call, unless it saw no
    such kernel or less time than the bound — the trace then lost kernel
    events (seen at the largest shapes) and the CUDA-event time per call of
    a back-to-back loop is taken instead."""
    dev_ms, ev_ms, _ = measure(torch, fn, iters, kernel_name)
    if dev_ms is not None and dev_ms >= bound:
        return dev_ms, "device"
    return ev_ms, "events"


def _timing_row(torch, tag, call, kernel_name, nbytes, nops, iters, card,
                library=None):
    """Time the kernel, its plain version (fewer calls: it is many
    launches) and, if given, the library call; print one line and return
    the `kernels`-line fields."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, nops / F32_OPS_PER_S
    bound, by = max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                            else "operations")
    ms, src = _timed(torch, call, iters, kernel_name, bound)
    plain_ms, plain_src = _timed(torch, lambda: call("torch"),
                                 max(5, iters // 10), None, bound)
    lib_ms, lib = None, "no library call"
    if library is not None:
        lib_ms, lib_src = _timed(torch, library, iters, None, bound)
        lib = f"library {lib_ms:.5f} ms ({lib_src})"
    print(f"kernel {tag}: kernel {ms:.5f} ms ({src}), plain "
          f"{plain_ms:.5f} ms ({plain_src}), {lib}, bound {bound:.6f} ms "
          f"({by}) [{card}]")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                library_ms=lib_ms)


def quant_input(torch, n, d, dev, seed):
    """Rows of mixed magnitudes; with n > 2 one all-zero row and one row of
    half-way ties (max|x| = 127 makes its scale exactly 1.0)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = (torch.randn(n, d, generator=g, device=dev)
         * torch.rand(n, 1, generator=g, device=dev) * 50)
    if n > 2:
        x[1] = 0.0
        ties = torch.tensor([127.0, 2.5, -0.5, 1.5, 3.5, -2.5, 0.5, -126.5],
                            device=dev)
        x[2] = ties.repeat(d // 8 + 1)[:d]
    return x


def _offset(torch, t, offset):
    """A contiguous copy of `t` starting `offset` elements into its
    allocation (a row of a batch tensor, as `FlatCache.set_row` passes)."""
    buf = torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)
    view = buf[offset:offset + t.numel()].view(t.shape)
    view.copy_(t)
    return view


def _plan_text(plan):
    C, T, V, on_chip = plan
    if on_chip == "grid":
        return (f"cooperative grid, {C} blocks a row of {T} threads, {V} "
                f"loads a thread in flight")
    return (f"cluster {C}, {T} threads a block, slice in {on_chip}"
            f"{f' ({V} vectors a thread)' if on_chip == 'registers' else ''}")


def compare_quant(torch, ops, n, d, dev, card, timed=True, quiet=False,
                  iters=None):
    """quantize_rows at (n, d), also with x at 4, 8 and 12 bytes past a
    16-byte line: q and s bit-identical to the plain version. Prints the
    launch plan unless `quiet`. Timed (the profiler's device time over 200
    calls, or 10 at 10^7 numbers and more; with `iters`, CUDA events over
    that many) beside the plain version, the bound (5 B a number), the
    two-pass floor (9 B a number) and the other kind of plan at the same
    shape: a grid plan beside the cluster plan it replaces (and that plan's
    time in the table, where it has one), a cluster plan beside the grid's
    where the card holds one. Returns (max abs error of s, timing row or
    None)."""
    from repro_torch.kernels import quant as kq
    x = quant_input(torch, n, d, dev, seed=n + d % 1000)
    q1, s1 = ops.quantize_rows(x)
    q2, s2 = ops.quantize_rows(x, backend="torch")
    torch.cuda.synchronize()
    tag = f"quantize_rows n={n} d={d}"
    check(torch.equal(q1, q2), f"{tag}: int8 codes differ from plain")
    check(torch.equal(s1, s2), f"{tag}: scales differ from plain")
    if n > 2:
        check(float(s1[1]) > 0 and not bool(q1[1].any()),
              f"{tag}: all-zero row")
        check(q1[2, :8].tolist() == [127, 2, 0, 2, 4, -2, 0, -126][:d],
              f"{tag}: half-way ties not rounded to even")
    for off in (1, 2, 3):
        qo, so = ops.quantize_rows(_offset(torch, x, off))
        check(torch.equal(qo, q2) and torch.equal(so, s2),
              f"{tag}: x at offset {4 * off} B differs from plain")
    if quiet:
        return 0.0, None
    sms = kq._sm_count(dev)
    plan = kq._quant_plan(n, d, sms)
    rows_note = "all-zero row, half-way ties and " if n > 2 else ""
    print(f"kernel {tag}: q and s bit-identical ({rows_note}x at offsets "
          f"4/8/12 B included); plan: {_plan_text(plan)} [{card}]")
    if not timed:
        return 0.0, None
    symbol = KERNEL_SYMBOLS["quantize_rows"]
    call = lambda b=None: ops.quantize_rows(x, backend=b)  # noqa: E731
    nbytes = n * d * 5 + n * 4
    if iters is None:       # the profiler's device time
        iters = 200 if n * d < 1e7 else 10
        row = _timing_row(torch, tag, call, symbol, nbytes, n * d * 6,
                          iters, card)

        def timed_ms(fn):
            return _timed(torch, fn, iters, symbol, row["bound_ms"])
    else:                   # a leaf view: CUDA events alone
        def timed_ms(fn):
            return _event_ms(torch, fn, iters), "events"
        row = dict(ms=timed_ms(call)[0], plain_ms=timed_ms(
            lambda: call("torch"))[0], bound_ms=nbytes / HBM_BYTES_PER_S * 1e3)
    floor = (n * d * 9 + n * 4) / HBM_BYTES_PER_S * 1e3
    note = ""
    try:
        other = (kq._cluster_plan(n, d, sms) if plan[3] == "grid"
                 else kq._grid_plan(n, d, sms))
    except ValueError:          # more rows than the grid's blocks
        other = None
    if other is not None:
        o_ms, o_src = timed_ms(lambda: kq.quantize_rows(x, plan=other))
        note = f"; the {_plan_text(other)}: {o_ms:.5f} ms ({o_src})"
    if (n, d) in CLUSTER_MS:
        note += (f", the table's earlier {CLUSTER_MS[n, d]:.5f} ms (the "
                 f"cluster plan, events; PERF.md §6)")
    print(f"kernel {tag}: {_plan_text(plan)} {row['ms']:.5f} ms, bound "
          f"{row['bound_ms']:.6f} ms, two-pass floor {floor:.6f} ms, plain "
          f"{row['plain_ms']:.5f} ms{note} [{card}]")
    return 0.0, row


def quant_symbols(torch, ops, dev, card):
    """The traces' name matching on the quant kernels: one quantize_rows
    launch on the grid, one on a cluster and one dequantize_rows launch,
    traced; `KERNEL_SYMBOLS` must count each launch as its own kernel's
    and no launch as both."""
    from repro_torch.kernels import quant as kq
    x = quant_input(torch, 1, D_LARGE, dev, seed=3)
    grid = kq._grid_plan(1, D_LARGE, kq._sm_count(dev))
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        q, s = kq.quantize_rows(x, plan=grid)
        kq.quantize_rows(x[:, :D_SLICE].contiguous(), plan=kq._cluster_plan(
            1, D_SLICE, kq._sm_count(dev)))
        ops.dequantize_rows(q, s)
        torch.cuda.synchronize()
    counts = {name: {} for name in ("quantize_rows", "dequantize_rows")}
    for e in device_kernels(torch, prof):
        for name, seen in counts.items():
            if symbol_matches(KERNEL_SYMBOLS[name], e.key):
                seen[e.key] = seen.get(e.key, 0) + e.count
    both = set(counts["quantize_rows"]) & set(counts["dequantize_rows"])
    check(sum(counts["quantize_rows"].values()) == 2 and len(
        counts["quantize_rows"]) == 2 and sum(
        counts["dequantize_rows"].values()) == 1 and not both,
        f"quant kernels' names matched wrongly: {counts}")
    print(f"trace names: quantize_rows counts "
          f"{sorted(k[:60] for k in counts['quantize_rows'])}, "
          f"dequantize_rows {sorted(k[:60] for k in counts['dequantize_rows'])}"
          f"; none counted twice [{card}]")


def compare_dequant(torch, ops, n, d, dev, card, timed=True, quiet=False):
    """dequantize_rows at (n, d), also with q 1-3, 4, 8 and 12 bytes past
    an aligned address: bit-identical to the plain version and to
    torch.mul(q, s[:, None]). Prints the launch plan unless `quiet`."""
    from repro_torch.kernels import quant as kq
    q, s = ops.quantize_rows(quant_input(torch, n, d, dev, seed=7 + n),
                             backend="torch")
    x1 = ops.dequantize_rows(q, s)
    x2 = ops.dequantize_rows(q, s, backend="torch")
    x3 = torch.mul(q, s[:, None])
    torch.cuda.synchronize()
    tag = f"dequantize_rows n={n} d={d}"
    check(torch.equal(x1, x2), f"{tag}: differs from plain")
    check(torch.equal(x1, x3), f"{tag}: differs from torch.mul(q, s)")
    for off in (1, 2, 3, 4, 8, 12):
        check(torch.equal(ops.dequantize_rows(_offset(torch, q, off), s), x2),
              f"{tag}: q at offset {off} B differs from plain")
    if quiet:
        return 0.0, None
    head, W, vec_q, T, blocks = kq._dequant_plan(n, d, q.data_ptr(),
                                                 x1.data_ptr())
    print(f"kernel {tag}: bit-identical to the plain version and to "
          f"torch.mul(q, s[:, None]) (q at offsets 1-3/4/8/12 B included); "
          f"plan: {W} codes a thread, {blocks} blocks of {T} [{card}]")
    if not timed:
        return 0.0, None
    iters = 200 if n * d < 1e7 else 10
    row = _timing_row(torch, tag, lambda b=None: ops.dequantize_rows(
        q, s, backend=b), "dequantize_rows_kernel", n * d * 5 + n * 4,
        n * d, iters, card, library=lambda: torch.mul(q, s[:, None]))
    return 0.0, row


def compare_masked_agg(torch, ops, n, d, dev, card):
    """masked_agg at (n, d) with random, all-true and all-false masks:
    within 1e-6 of the output's scale (and reported bit-identical or not).
    Returns (max abs error, timing row of the random mask)."""
    g = torch.Generator(device=dev).manual_seed(n + d % 997)
    q, s = ops.quantize_rows(torch.randn(n, d, generator=g, device=dev),
                             backend="torch")
    err, row = 0.0, None
    masks = {"random": torch.rand(n, generator=g, device=dev) < 0.4,
             "all-true": torch.ones(n, dtype=torch.bool, device=dev),
             "all-false": torch.zeros(n, dtype=torch.bool, device=dev)}
    for label, mask in masks.items():
        u1 = ops.masked_agg(q, s, mask)
        u2 = ops.masked_agg(q, s, mask, backend="torch")
        torch.cuda.synchronize()
        tag = f"masked_agg n={n} d={d} {label} mask"
        e, rel = _err(torch, u1, u2)
        check(rel <= F32_TOL, f"{tag}: f32 error {e} > tolerance")
        if label == "all-false":
            check(not bool(u1.any()), f"{tag}: not all zeros")
        err = max(err, e)
        print(f"kernel {tag}: max_abs_err {e:.3e} (tolerance {F32_TOL:g} of "
              f"the output's scale), bit-identical: "
              f"{bool(torch.equal(u1, u2))} [{card}]")
        if label == "random":
            iters = 200 if d < 1e6 else 5
            row = _timing_row(
                torch, tag, lambda b=None: ops.masked_agg(q, s, mask,
                                                          backend=b),
                "masked_agg_kernel", n * d + 5 * n + 4 * d, 2 * n * d,
                iters, card)
    return err, row


def _fmt(x):
    return "n/a" if x is None else f"{x:.5f}"


# --- phase 4: the main path -----------------------------------------------------

BUFFERED = ("ca2fl", "ca2fl_direct", "fedbuff")    # buffer 10
# the configurations timed eager against graph and traced
TRACED = (("ace", "int8", K_SLICE), ("ace", "int8", 1), ("aced", "int8", 1),
          ("aced_direct", "int8", 1), ("ace_direct", "int8", 1))
CACHE_INIT = ("ace", "aced", "ace_direct", "aced_direct")


def _depth(rule, K):
    """(T, n_events) of a 300-tick run: the cache-init rules spend
    iteration 0 on the init batch; a buffered rule (buffer 10) emits every
    10th arrival at K = 1 and every tick at K = 16."""
    if rule in BUFFERED:
        return (30, 300) if K == 1 else (300, 300)
    return (300, 299) if rule in CACHE_INIT else (300, 300)


def engine_runs():
    """(rule, cache dtype, K, T, n_events, kernels it must launch) of the
    main path: the incremental rules (ACE, ACED, CA²FL), then the rest of
    the zoo (the baselines carry no cache and launch no kernel)."""
    runs = []
    for dtype, K in (("int8", 1), ("int8", K_SLICE), ("float32", 1),
                     ("float32", K_SLICE)):
        for rule in ("ace", "aced", "ca2fl"):
            if dtype == "float32" and K == 1:
                kernels = ()                      # no kernel on this path
            elif K == 1:
                kernels = ("cache_row_update",) if rule == "ace" \
                    else ("row_delta",)
            else:
                kernels = ("commit_batch",)
            if dtype == "int8" and rule in CACHE_INIT:
                kernels += ("quantize_rows",)            # the int8 init
            runs.append((rule, dtype, K) + _depth(rule, K) + (kernels,))
    for K in (1, K_SLICE):
        for rule in ("asgd", "delay_asgd", "fedbuff"):
            runs.append((rule, None, K) + _depth(rule, K) + ((),))
    for dtype in ("int8", "float32"):
        for rule in ("ace_direct", "aced_direct", "ca2fl_direct"):
            kernels = ()
            if dtype == "int8":
                kernels = (("masked_agg", "quantize_rows")
                           if rule == "aced_direct"
                           else ("quantize_rows", "dequantize_rows"))
            runs.append((rule, dtype, 1) + _depth(rule, 1) + (kernels,))
    return runs


def make_rule(rule, dtype, K, backend=None):
    from repro_torch.core import (ACED, CA2FL, ACEDDirect, ACEDirect,
                                  ACEIncremental, CA2FLDirect,
                                  DelayAdaptiveASGD, FedBuff, VanillaASGD)
    if rule == "ace":
        return ACEIncremental(cache_dtype=dtype, backend=backend)
    if rule == "aced":
        return ACED(tau_algo=10, cache_dtype=dtype, max_cohort=K,
                    backend=backend)
    if rule == "ca2fl":
        return CA2FL(buffer_size=10, cache_dtype=dtype, backend=backend)
    if rule == "asgd":
        return VanillaASGD()
    if rule == "delay_asgd":
        # AFLConfig's defaults: τ_C = max_delay_scale · delay_beta = 4 · 5
        return DelayAdaptiveASGD(tau_c=20.0)
    if rule == "fedbuff":
        return FedBuff(buffer_size=10)
    if rule == "ace_direct":
        return ACEDirect(cache_dtype=dtype, backend=backend)
    if rule == "aced_direct":
        return ACEDDirect(tau_algo=10, cache_dtype=dtype, backend=backend)
    return CA2FLDirect(buffer_size=10, cache_dtype=dtype, backend=backend)


def engine_runner(task, rule, dtype, K, T, dev, backend=None, graph=None,
                  **statics):
    """`make_staleness_runner` for one configuration of the main path:
    the tick captured as a CUDA graph (graph=None on the card), or eager
    (graph=False); `statics` are its guards and resync cadence (and, for
    phase 4e, its layout and history dtype)."""
    from repro_torch.core import make_staleness_runner
    return make_staleness_runner(
        grad_fn=task.grad_fn, params0=task.params0,
        aggregator=make_rule(rule, dtype, K, backend),
        n_clients=task.n_clients, T=T, beta=5.0, k_batch=K, device=dev,
        graph=graph, **statics)


def engine_streams(task, K, E, dev, seed=0):
    """The run's random streams, drawn on the card from `seed` as
    `run_staleness_scan` draws them."""
    from repro_torch.core.scan_staleness import (build_payload_noise,
                                                 build_staleness_randomness)
    return (build_staleness_randomness(seed, E, task.n_clients, 5.0,
                                       k_batch=K, device=dev),
            build_payload_noise(task.grad_fn, seed, E, task.n_clients, K,
                                device=dev))


def engine_lr(task, T):
    import numpy as np
    return 0.2 * float(np.sqrt(task.n_clients / T))


def run_engine(torch, runner, *args):
    """One runner call ``runner(*args)`` (a staleness runner's streams, lr
    and, guarded, its fault schedule and clip_norm; an event runner's
    schedule and noise), host clock around it to a device sync -> (its
    result, seconds)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = runner(*args)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def tensors_of(tree):
    """Every tensor of a model or a state, either layout, in leaf order: a
    `FlatCache` gives its rows and scales, a tree cache each leaf's."""
    from repro_torch.convert import leaves
    from repro_torch.core.cache import cache_tensors
    return [t for v in leaves(tree) for t in (cache_tensors(v) or [v])]


def same_tensors(torch, a, b):
    ta, tb = tensors_of(a), tensors_of(b)
    return len(ta) == len(tb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(ta, tb))


def same_run(torch, a, b):
    """Model, every cache's int8 rows (or f32 rows) and scales, every other
    state tensor, every per-event output (a quarantined event's update
    norm is NaN in both) and the guard counters, bit for bit — in either
    layout (a tree model and tree caches leaf by leaf)."""
    (w1, s1, o1, x1), (w2, s2, o2, x2) = a, b
    same = (same_tensors(torch, w1, w2) and s1.keys() == s2.keys()
            and same_tensors(torch, s1, s2))
    same = same and o1.keys() == o2.keys() and all(
        _same(torch, o1[k].float(), o2[k].float()) for k in o1)
    g1, g2 = x1.get("guards", {}), x2.get("guards", {})
    return bool(same and g1.keys() == g2.keys() and all(
        torch.equal(g1[k], g2[k]) for k in g1))


TRACE_ATTEMPTS = 3


class _KernelRow:
    """One device kernel's row of a trace: its name, launches and device
    microseconds."""
    __slots__ = ("key", "count", "self_device_time_total")

    def __init__(self, key):
        self.key, self.count, self.self_device_time_total = key, 0, 0.0


def device_kernels(torch, prof):
    """A trace's device events summed by name, as `key_averages()` sums its
    device rows (the same rows, launches and times), read straight from the
    profiler's kineto results: building the Python events that
    `key_averages()` aggregates took 7.8–8.0 s for a 300-tick graph run at
    287 kernels a tick, this 0.9 s (PR 29 calls 4 and 6)."""
    from torch.autograd.profiler_util import _rewrite_name
    result = prof.profiler.kineto_results
    t0 = result.trace_start_ns()
    cuda = torch.autograd.DeviceType.CUDA
    rows = {}
    for e in result.events():
        if (e.device_type() != cuda
                or getattr(e, "is_hidden_event", lambda: False)()):
            continue
        key = _rewrite_name(name=e.name(), with_wildcard=True)
        row = rows.get(key)
        if row is None:
            row = rows[key] = _KernelRow(key)
        row.count += 1
        if not (e.is_async() or e.start_thread_id() != e.end_thread_id()):
            # a FunctionEvent's interval: microseconds from the trace start
            row.self_device_time_total += ((e.end_ns() - t0) / 1000
                                           - (e.start_ns() - t0) / 1000)
    return list(rows.values())


def trace_engine(torch, ops, label, runner, args, E, tick_ms, card,
                 per_tick_expected=None, must=(), top=6, groups=None):
    """One traced graph run of `runner(*args)`: device busy ms and device
    kernels a tick, the idle share against the untraced wall clock
    `tick_ms`, the six largest kernels, and each port kernel's launches in
    the trace checked against its counter (the captured tick's counts ×
    replays) and, where given, the device kernels a tick against
    `per_tick_expected` (within half a kernel). The profiler on that
    machine at times loses kernel events (a replayed kernel seen fewer
    times than the graph ran it, the run bit-identical to its eager run);
    such a trace is taken again, up to `TRACE_ATTEMPTS` traces in all, so
    a difference that every trace shows still fails. Returns (device busy
    ms a tick, device kernels a tick). Each kernel named in `must` has to
    be seen in the replays. `top` is the number of largest kernels printed;
    `groups` maps a label to a regular expression over kernel names, and
    each group's device ms a tick, launches a tick and share of the busy
    time is printed."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    t0 = time.perf_counter()
    for attempt in range(1, TRACE_ATTEMPTS + 1):
        ops.reset_launch_counts()
        with torch.profiler.profile(activities=acts) as prof:
            torch.cuda.synchronize()
            runner(*args)
            torch.cuda.synchronize()
        counts = ops.launch_counts()
        device_events = device_kernels(torch, prof)
        per_tick = sum(e.count for e in device_events) / E
        ours = {name: [e for e in device_events
                       if symbol_matches(symbol, e.key)]
                for name, symbol in KERNEL_SYMBOLS.items()}
        seen = {name: sum(e.count for e in evs) for name, evs in ours.items()}
        off = {name: (seen[name], counts[name]) for name in seen
               if seen[name] != counts[name]}
        # every tick replays one graph, so its kernels are a whole number;
        # the init's eager kernels add a fraction to the ratio (and a lost
        # event takes one away), a kernel more or less a tick adds ±1
        if (per_tick_expected is not None
                and abs(per_tick - per_tick_expected) >= 0.5):
            off["device kernels a tick"] = (per_tick, per_tick_expected)
        if not off:
            break
        print(f"  {label}: trace {attempt} differs (seen, expected): {off}"
              f"{'; tracing again' if attempt < TRACE_ATTEMPTS else ''}")
    check(not off, f"{label}: every one of {TRACE_ATTEMPTS} traces differs "
          f"(seen, expected): {off}")
    for name in must:
        check(seen[name] > 0, f"{label}: no {name} launch in the replays")
    busy_ms = sum(e.self_device_time_total for e in device_events) / 1e3 / E
    print(f"engine {label}: device busy {busy_ms:.4f} ms per tick of "
          f"{tick_ms:.4f} ms wall, idle share {1 - busy_ms / tick_ms:.3f}, "
          f"{per_tick:.1f} device kernels per tick (traced in "
          f"{time.perf_counter() - t0:.1f} s) [{card}]")
    largest = sorted(device_events,
                     key=lambda e: -e.self_device_time_total)[:top]
    for e in largest:
        print(f"  {e.self_device_time_total / 1e3 / E:.4f} ms/tick "
              f"{e.count / E:.1f} launches/tick  {e.key[:90]}")
    for group, pattern in (groups or {}).items():
        evs = [e for e in device_events if re.search(pattern, e.key, re.I)]
        ms = sum(e.self_device_time_total for e in evs) / 1e3 / E
        print(f"  group {group}: {ms:.4f} ms/tick, "
              f"{sum(e.count for e in evs) / E:.1f} launches/tick, "
              f"{ms / busy_ms if busy_ms else 0.0:.3f} of the busy time")
    report = []
    for name, evs in ours.items():
        if evs:
            ms = sum(e.self_device_time_total for e in evs) / 1e3 / E
            report.append(f"{name} {ms:.4f} ms/tick ({seen[name] / E:.1f} "
                          f"launches/tick, {seen[name]} in the run)")
    print(f"  the port's kernels seen in the replays: "
          f"{'; '.join(report) or 'none'}; each kernel's launches in the "
          f"trace equal its counter's: True")
    return busy_ms, per_tick


def time_and_trace(torch, ops, prefix, kept, card, untraced=(), must=()):
    """Eager against graph in turns (eager, graph, graph, eager), untraced
    — the graphs were captured before, so a graph call is its replays plus
    the streams' copies and the init — then where a tick's time goes: one
    traced graph run each (but those in `untraced`) against the untraced
    graph runs' wall clock (the trace itself slows the host); the kernels
    in `must` seen in every trace. `kept` maps (rule, dtype, K) to (graph
    runner, eager runner, call args, events, arrivals a tick). Returns
    ({key: device kernels a tick}, {key: graph wall ms a tick})."""
    graph_ms = {}
    for key, (runner, eager, args, E, K) in kept.items():
        rule, dtype, _ = key
        walls = [run_engine(torch, r, *args)[1]
                 for r in (eager, runner, runner, eager)]
        ms = [1e3 * x / E for x in walls]
        graph_ms[key] = (ms[1] + ms[2]) / 2
        print(f"engine A/B {prefix}{rule} {dtype} K={K}: wall ms per tick "
              f"eager {ms[0]:.4f}, graph {ms[1]:.4f}, graph {ms[2]:.4f}, "
              f"eager {ms[3]:.4f}; arrivals/s "
              f"{', '.join(f'{E * K / x:.1f}' for x in walls)} [{card}]")
    per_tick = {}
    for key, (runner, _, args, E, K) in kept.items():
        if key in untraced:
            continue
        rule, dtype, _ = key
        per_tick[key] = trace_engine(
            torch, ops, f"{prefix}{rule} {dtype} K={K} graph", runner, args,
            E, graph_ms[key], card, must=must)[1]
    return per_tick, graph_ms


# --- phase 4b: faults, guards, resync and sweeps ----------------------------

FAULT_RATES = dict(nan_rate=0.05, explode_rate=0.05, byzantine_rate=0.05,
                   overstale_rate=0.05)
FAULTED = (("ace", "int8", 1), ("aced", "int8", 1), ("ca2fl", "int8", 1),
           ("ace", "int8", K_SLICE), ("aced", "float32", K_SLICE),
           ("aced_direct", "int8", 1))
# guards on with a clean schedule against phase 4's guards-off run
CLEAN_GUARDED = (("ace", "int8", 1), ("ace", "int8", K_SLICE))
# guards off against on, timed in turns and traced
GUARD_TIMED = (("ace", "int8", 1), ("aced", "int8", 1), ("ace", "int8", K_SLICE))
RESYNC, RESYNC_EVERY = (("aced", "int8", 1), ("ca2fl", "int8", 1)), 10


def counted(ops, totals, fn):
    """`fn()` with the launch counts set to 0 just before it and added to
    the run's totals just after -> (its result, its counts)."""
    ops.reset_launch_counts()
    out = fn()
    counts = ops.launch_counts()
    for k, v in counts.items():
        totals[k] += v
    return out, counts


def clip_norm_of(torch, task, dev):
    """The clip threshold of the faulted runs: the median norm of the n
    clients' payloads at w⁰ on seed 0's init noise, so that the clip takes
    some clean events as well as every exploded one."""
    from repro_torch.convert import ravel
    n = task.n_clients
    w0 = ravel(task.params0).to(dev)
    noise = engine_streams(task, 1, 1, dev)[1].init
    _, g = task.grad_fn(w0[None].repeat(n, 1), torch.arange(n, device=dev),
                        noise[:, 0])
    return float(torch.linalg.vector_norm(g, dim=1).median())


def guarded_run(torch, ops, task, dev, card, totals, rule, dtype, K, clip,
                faults=True, **statics):
    """A guarded run of one configuration through the graph runner and
    again eagerly, on seed 0's streams (and its fault schedule, or an
    all-clean one with the clip off): bit for bit, one capture, the rule's
    kernels launched, a finite model. -> (runner, call args, run, accuracy,
    launch counts)."""
    from repro_torch.convert import unravel
    from repro_torch.core import build_fault_schedule, no_faults
    T, E = _depth(rule, K)
    streams, lr = engine_streams(task, K, E, dev), engine_lr(task, T)
    guard = ((build_fault_schedule(0, E, k_batch=K, device=dev,
                                   **FAULT_RATES), clip) if faults
             else (no_faults(E, K, device=dev), 0.0))
    label = f"{rule} {dtype} K={K}"
    runner = engine_runner(task, rule, dtype, K, T, dev, guards=True,
                           **statics)
    (out, wall), counts = counted(ops, totals, lambda: run_engine(
        torch, runner, *streams, lr, *guard))
    check(runner.captures == 1, f"{label}: {runner.captures} captures")
    kernels = {(r, dt, k): ks for r, dt, k, _, _, ks in engine_runs()}
    for kernel in kernels[rule, dtype, K]:
        check(counts[kernel] > 0, f"{label}: {kernel} was not launched")
    eager = engine_runner(task, rule, dtype, K, T, dev, graph=False,
                          guards=True, **statics)
    ref, wall_e = run_engine(torch, eager, *streams, lr, *guard)
    check(same_run(torch, out, ref), f"{label} guarded: the graph run "
          "differs from the eager run")
    w = out[0]
    check(bool(torch.isfinite(w).all()), f"{label}: non-finite model")
    acc = task.eval_fn(unravel(w, task.params0))["accuracy"]
    return runner, (*streams, lr, *guard), out, acc, counts, wall, wall_e


def guard_phase(torch, ops, task, dev, card, totals, clean):
    """Faulted runs, guards on a clean schedule, resync, the lr × seed grid
    and a faulted seed sweep on the main path, then guards off against on
    and resync against none, timed in turns and traced."""
    import numpy as np
    from repro_torch.core import (build_fault_schedule, run_staleness_grid,
                                  run_staleness_scan, run_staleness_seeds)
    from repro_torch.core.staleness_sim import default_tau_max
    clip = clip_norm_of(torch, task, dev)
    print(f"engine guards: fault rates {FAULT_RATES}, clip_norm {clip:.6g} "
          f"(the median payload norm at w0), seed 0's schedule, full width "
          f"[{card}]")
    on = {}
    for rule, dtype, K in FAULTED:
        runner, args, out, acc, counts, wall, wall_e = guarded_run(
            torch, ops, task, dev, card, totals, rule, dtype, K, clip)
        label = f"{rule} {dtype} K={K}"
        guards = {k: int(v) for k, v in out[3]["guards"].items()}
        flags = {k: int(out[2][k].sum()) for k in guards}
        check(guards == flags, f"{label}: counters {guards} are not the "
              f"flags' sums {flags}")
        check(all(v > 0 for v in guards.values()),
              f"{label}: a guard never fired: {guards}")
        check(acc > 0.5, f"{label} faulted: accuracy {acc}")
        print(f"engine faulted {label}: {int(out[2]['emit'].sum())} "
              f"updates in {len(out[2]['emit'])} ticks, guard counters "
              f"{guards} (graph = eager, and the "
              f"flags' sums), accuracy {acc:.4f}; graph run {wall:.2f} s "
              f"with its capture, eager run {wall_e:.2f} s; graph and eager "
              f"bit-identical: True; launches {counts} [{card}]")
        on[rule, dtype, K] = (runner, args, out)

    for rule, dtype, K in CLEAN_GUARDED:
        T, E = _depth(rule, K)
        tau = engine_streams(task, K, E, dev)[0].tau_raw
        natural = int((tau.floor() > default_tau_max(5.0)).sum())
        check(natural == 0, f"{rule} {dtype} K={K}: seed 0 holds {natural} "
              "naturally over-stale requests, which the guards reject")
        _, _, out, _, _, _, _ = guarded_run(
            torch, ops, task, dev, card, totals, rule, dtype, K, clip,
            faults=False)
        off = clean[rule, dtype, K]
        w, state, outs, _ = out
        check(same_run(torch, off, (w, state, {k: outs[k] for k in off[2]},
                                    {})),
              f"{rule} {dtype} K={K}: guards on a clean schedule differ "
              "from guards off")
        print(f"engine {rule} {dtype} K={K} guards on, clean schedule, "
              f"clip off: bit-identical to the guards-off run: True, "
              f"counters {({k: int(v) for k, v in out[3]['guards'].items()})}"
              f" [{card}]")

    synced_runs, resync_guards = {}, {}
    for rule, dtype, K in RESYNC:
        runner, args, out, acc, counts, wall, _ = guarded_run(
            torch, ops, task, dev, card, totals, rule, dtype, K, clip,
            resync_every=RESYNC_EVERY)
        state = out[1]
        healed = make_rule(rule, dtype, K).resync(state)
        devs = {}
        for k, v in healed.items():
            if v is state[k]:
                continue
            ref = v.double()
            devs[k] = float((state[k].double() - ref).abs().max()
                            / max(1e-12, float(ref.abs().max())))
            check(devs[k] <= 1e-4, f"{rule} {dtype} K={K} resync: {k} "
                  f"{devs[k]} (relative) from a fresh resync")
        print(f"engine resync {rule} {dtype} K={K} every {RESYNC_EVERY}: "
              f"faulted, graph = eager bit for bit, final running sums "
              f"against a fresh resync (relative) {devs}, accuracy "
              f"{acc:.4f}, guard counters "
              f"{({k: int(v) for k, v in out[3]['guards'].items()})}; "
              f"launches {counts} [{card}]")
        synced_runs[rule, dtype, K] = (runner, args)
        resync_guards[rule, dtype, K] = {
            k: int(v) for k, v in out[3]["guards"].items()}

    # the lr × seed grid on one capture against six single runs (six
    # captures), in turns: singles, grid, grid, singles
    rule, dtype, K = "ace", "int8", 1
    T, E = _depth(rule, K)
    lr0 = engine_lr(task, T)
    lrs, seeds = (0.5 * lr0, lr0, 2 * lr0), (0, 1)
    kw = dict(grad_fn=task.grad_fn, params0=task.params0,
              n_clients=task.n_clients, T=T, beta=5.0, device=dev)
    runner = engine_runner(task, rule, dtype, K, T, dev)

    def grid():
        return run_staleness_grid(aggregator=make_rule(rule, dtype, K),
                                  lrs=lrs, seeds=seeds, runner=runner, **kw)

    def singles():
        return [[run_staleness_scan(aggregator=make_rule(rule, dtype, K),
                                    server_lr=lr, seed=s, **kw)
                 for s in seeds] for lr in lrs]
    walls, out = [], {}
    for name, fn in (("singles", singles), ("grid", grid), ("grid", grid),
                     ("singles", singles)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out[name], _ = counted(ops, totals, fn)
        walls.append(time.perf_counter() - t0)
    check(runner.captures == 1, f"grid: {runner.captures} captures")
    for i in range(len(lrs)):
        for j in range(len(seeds)):
            a, b = out["grid"][i][j], out["singles"][i][j]
            check(np.array_equal(a.w, b.w) and np.array_equal(a.emit, b.emit)
                  and np.array_equal(a.losses, b.losses)
                  and np.array_equal(a.update_norms, b.update_norms),
                  f"grid cell (lr {lrs[i]}, seed {seeds[j]}) differs from "
                  "its single run")
    cells = len(lrs) * len(seeds)
    print(f"engine grid {rule} {dtype} K={K}: {len(lrs)} lrs x "
          f"{len(seeds)} seeds, {E} ticks a cell, one capture "
          f"(runner.captures == 1 after two grids), every cell bit-identical "
          f"to its run_staleness_scan; wall s singles (6 captures) "
          f"{walls[0]:.3f}, grid {walls[1]:.3f}, grid {walls[2]:.3f}, "
          f"singles {walls[3]:.3f}; cells/s "
          f"{', '.join(f'{cells / x:.2f}' for x in walls)}; arrivals/s "
          f"{', '.join(f'{cells * E * K / x:.1f}' for x in walls)} [{card}]")

    rule, dtype, K = "aced", "int8", 1
    sweep, counts = counted(ops, totals, lambda: run_staleness_seeds(
        aggregator=make_rule(rule, dtype, K), server_lr=engine_lr(task, 300),
        seeds=(0, 1), n_events=360, fault_rates=FAULT_RATES,
        clip_norm=clip, **kw))
    for s, r in zip((0, 1), sweep):
        check(np.isfinite(r.w).all() and r.faults["quarantined"] > 0,
              f"faulted seed sweep, seed {s}: {r.faults}")
        print(f"engine seeds {rule} {dtype} K={K}, seed {s}: "
              f"{len(r.ts)} updates in 360 ticks, guard counters "
              f"{r.faults}, scheduled "
              f"{build_fault_schedule(s, 360, device=dev, **FAULT_RATES).counts()}"
              f" [{card}]")
    print(f"engine seeds: launches {counts} [{card}]")

    # guards off against on (faulted), and resync against none, in turns
    # (off, on, on, off); the graphs are captured before the turns
    pairs = []
    for key in GUARD_TIMED:
        rule, dtype, K = key
        T, E = _depth(rule, K)
        streams, lr = engine_streams(task, K, E, dev), engine_lr(task, T)
        off = engine_runner(task, rule, dtype, K, T, dev)
        run_engine(torch, off, *streams, lr)
        runner, args, _ = on[key]
        pairs.append((f"{rule} {dtype} K={K} guards", E, K,
                      ("off", off, (*streams, lr)), ("on", runner, args)))
    key = ("aced", "int8", 1)
    runner, args, _ = on[key]
    pairs.append((f"aced int8 K=1 resync (guards on, faulted)",
                  _depth("aced", 1)[1], 1, ("none", runner, args),
                  (f"every {RESYNC_EVERY}", *synced_runs[key])))
    for label, E, K, (n1, r1, a1), (n2, r2, a2) in pairs:
        walls = []
        for r, a in ((r1, a1), (r2, a2), (r2, a2), (r1, a1)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r(*a)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        ms = [1e3 * x / E for x in walls]
        print(f"engine A/B {label}: wall ms per tick {n1} {ms[0]:.4f}, {n2} "
              f"{ms[1]:.4f}, {n2} {ms[2]:.4f}, {n1} {ms[3]:.4f}; arrivals/s "
              f"{', '.join(f'{E * K / x:.1f}' for x in walls)} [{card}]")
        for name, r, a, tick_ms in ((n1, r1, a1, (ms[0] + ms[3]) / 2),
                                    (n2, r2, a2, (ms[1] + ms[2]) / 2)):
            trace_engine(torch, ops, f"{label} {name} graph", r, a, E,
                         tick_ms, card)
    return resync_guards


# --- phase 4c: the text task, the event engine and the sanitize checks -----

# the text task's runs (Table a.2's rules): int8 and f32 caches at K = 1,
# int8 at K = 16, and ASGD
TEXT_RUNS = ([(rule, dtype, 1) for rule in ("ace", "aced", "ca2fl")
              for dtype in ("int8", "float32")]
             + [(rule, "int8", K_SLICE) for rule in ("ace", "aced", "ca2fl")]
             + [("asgd", None, 1)])
TEXT_TIMED = (("ace", "int8", 1), ("aced", "int8", 1), ("ace", "int8", K_SLICE))
# timed, not traced: tracing the text task's K = 16 graph run (its embedding
# backward sorts the 32,768 indices) crashed the process inside the
# profiler on the H100 (a segmentation fault); its K = 1 runs trace
TEXT_UNTRACED = (("ace", "int8", K_SLICE),)
# the event engine's runs (K = 1) and those timed in turns and traced
EVENT_RUNS = (("ace", "int8"), ("ace", "float32"), ("aced", "int8"),
              ("ca2fl", "int8"), ("aced_direct", "int8"), ("asgd", None))
EVENT_TIMED = (("ace", "int8"), ("aced", "int8"))
EVENT_KAPPA, EVENT_T = 4.0, 300


def _must_launch(rule, dtype, K):
    """The kernels a configuration launches (phase 4's table)."""
    return {(r, dt, k): ks for r, dt, k, _, _, ks in engine_runs()}[
        rule, dtype, K]


def text_phase(torch, ops, dev, card, totals):
    """The text task at its defaults (n = 20, d = 70,996) on the staleness
    engine: each run through the graph runner and again eagerly, bit for
    bit, its kernels launched, the model finite and accuracy above 0.10
    (chance is 0.05); int8 ACE K = 16 run eagerly twice, bit for bit (the
    embedding gradient); int8 ACE K = 1 through the plain versions within
    1e-4 of the kernels' run; three configurations timed and traced."""
    import numpy as np
    from repro_torch.convert import ravel, unravel
    from repro_torch.core import make_text_task
    from repro_torch.kernels.cache_update import _ace_plan
    from repro_torch.kernels.quant import _sm_count
    task = make_text_task(device=dev)
    d = ravel(task.params0).numel()
    check(d == D_TEXT, f"text task has d={d}, expected {D_TEXT}")
    plan = _ace_plan(d, _sm_count(dev))
    check(plan[3] == "grid", f"cache_row_update at d={d}: plan {plan}")
    print(f"engine text: n={task.n_clients} clients, d={d}, batch 32, "
          f"vocab 1024, seq 64; cache_row_update's plan at d={d}: {plan} "
          f"(the cooperative grid) [{card}]")

    def lr_of(T):
        return 3.0 * float(np.sqrt(task.n_clients / T))
    kept, finals = {}, {}
    for rule, dtype, K in TEXT_RUNS:
        T, E = _depth(rule, K)
        label = f"text {rule} {dtype or 'no-cache'} K={K}"
        streams, lr = engine_streams(task, K, E, dev), lr_of(T)
        runner = engine_runner(task, rule, dtype, K, T, dev)
        (out, wall), counts = counted(ops, totals, lambda: run_engine(
            torch, runner, *streams, lr))
        check(runner.captures == 1, f"{label}: {runner.captures} captures")
        for kernel in _must_launch(rule, dtype, K):
            check(counts[kernel] > 0, f"{label}: {kernel} was not launched")
        w = out[0]
        check(bool(torch.isfinite(w).all()), f"{label}: non-finite model")
        acc = task.eval_fn(unravel(w, task.params0))["accuracy"]
        check(acc > 0.10, f"{label}: accuracy {acc} (chance 0.05)")
        eager = engine_runner(task, rule, dtype, K, T, dev, graph=False)
        ref, wall_e = run_engine(torch, eager, *streams, lr)
        check(same_run(torch, out, ref), f"{label}: the graph run differs "
              "from the eager run")
        note = ""
        if (rule, dtype, K) == ("ace", "int8", K_SLICE):
            again, _ = run_engine(torch, engine_runner(
                task, rule, dtype, K, T, dev, graph=False), *streams, lr)
            check(same_run(torch, ref, again), f"{label}: two eager runs "
                  "differ (the embedding gradient)")
            note = "; a second eager run bit-identical: True"
        print(f"engine {label}: T={T}, {E} ticks, lr {lr:.4f}, "
              f"{int(out[2]['emit'].sum())} updates, accuracy {acc:.4f}; "
              f"graph run {wall:.2f} s with its capture, eager run "
              f"{wall_e:.2f} s; graph and eager bit-identical: True{note}; "
              f"launches {counts} [{card}]")
        finals[rule, dtype, K] = w.cpu().numpy()
        if (rule, dtype, K) in TEXT_TIMED:
            kept[rule, dtype, K] = (runner, eager, (*streams, lr), E, K)
    rule, dtype, K = "ace", "int8", 1
    T, E = _depth(rule, K)
    plain = engine_runner(task, rule, dtype, K, T, dev, backend="torch",
                          graph=False)
    ops.reset_launch_counts()
    out, wall = run_engine(torch, plain, *engine_streams(task, K, E, dev),
                           lr_of(T))
    check(sum(ops.launch_counts().values()) == 0,
          "backend='torch' launched a kernel")
    res_w, ref_w = out[0].cpu().numpy(), finals[rule, dtype, K]
    dev_w = float(abs(res_w - ref_w).max() / max(1e-12, abs(ref_w).max()))
    check(dev_w <= 1e-4, f"text {rule} {dtype} K={K}: plain run deviates "
          f"{dev_w}")
    print(f"engine text {rule} {dtype} K={K} plain versions (eager): "
          f"{wall:.2f} s, final w within {dev_w:.3e} (relative) of the "
          f"kernels' run, bit-identical: {bool((res_w == ref_w).all())} "
          f"[{card}]")
    time_and_trace(torch, ops, "text ", kept, card, untraced=TEXT_UNTRACED)


def event_phase(torch, ops, task, dev, card, totals):
    """The event engine on the vision task at full width: κ = 4, β = 5,
    T = 300, concurrency n, schedule seed 0; each run through the graph
    runner and again eagerly, bit for bit (t_recv and w_recv too), its
    kernels launched and accuracy above 0.12 (chance is 0.1); a seed sweep
    on one capture against single runs; two rules timed and traced."""
    import numpy as np
    from repro_torch.convert import unravel
    from repro_torch.core import (ExponentialDelays, build_schedule,
                                  make_scan_runner, run_scan, run_scan_seeds)
    from repro_torch.core.scan_engine import (build_payload_noise,
                                              default_n_events)
    n, T = task.n_clients, EVENT_T
    lr = engine_lr(task, T)
    kw = dict(grad_fn=task.grad_fn, params0=task.params0, n_clients=n,
              server_lr=lr, T=T, device=dev)

    def delays(seed):
        return ExponentialDelays(beta=5.0, kappa=EVENT_KAPPA, n_clients=n,
                                 seed=seed)
    print(f"engine event: vision task, n={n}, d={D_SLICE}, kappa "
          f"{EVENT_KAPPA}, beta 5, T={T}, lr {lr:.4f}, concurrency n, "
          f"schedule seed 0 [{card}]")
    kept = {}
    for rule, dtype in EVENT_RUNS:
        label = f"event {rule} {dtype or 'no-cache'}"
        E = default_n_events(make_rule(rule, dtype, 1), T)
        sched = build_schedule(delays(0), E, None, 0)
        args = (sched.arrive, sched.dispatch,
                build_payload_noise(task.grad_fn, 0, E, n, device=dev))
        runner = make_scan_runner(aggregator=make_rule(rule, dtype, 1), **kw)
        (out, wall), counts = counted(ops, totals, lambda: run_engine(
            torch, runner, *args))
        check(runner.captures == 1, f"{label}: {runner.captures} captures")
        for kernel in _must_launch(rule, dtype, 1):
            check(counts[kernel] > 0, f"{label}: {kernel} was not launched")
        eager = make_scan_runner(aggregator=make_rule(rule, dtype, 1),
                                 graph=False, **kw)
        ref, wall_e = run_engine(torch, eager, *args)
        check(same_run(torch, (*out, {}), (*ref, {})) and all(
            torch.equal(runner.carry[k], eager.carry[k])
            for k in ("t_recv", "w_recv", "t")),
            f"{label}: the graph run differs from the eager run")
        w = out[0]
        check(bool(torch.isfinite(w).all()), f"{label}: non-finite model")
        acc = task.eval_fn(unravel(w, task.params0))["accuracy"]
        check(acc > 0.12, f"{label}: accuracy {acc} (chance 0.1)")
        print(f"engine {label}: {E} events, "
              f"{int(out[2]['emit'].sum())} updates, accuracy {acc:.4f}; "
              f"graph run {wall:.2f} s with its capture, eager run "
              f"{wall_e:.2f} s; graph and eager model, cache, state, "
              f"t_recv, w_recv and outputs bit-identical: True; launches "
              f"{counts} [{card}]")
        if (rule, dtype) in EVENT_TIMED:
            kept[rule, dtype, 1] = (runner, eager, args, E, 1)

    # a seed sweep on one capture against each seed's own run_scan
    rule, dtype, seeds = "ace", "int8", (0, 1)
    runner = make_scan_runner(aggregator=make_rule(rule, dtype, 1),
                              checkify_invariants=False, **kw)
    sweep, counts = counted(ops, totals, lambda: run_scan_seeds(
        aggregator=make_rule(rule, dtype, 1), seeds=seeds, beta=5.0,
        kappa=EVENT_KAPPA, runner=runner, **kw))
    check(runner.captures == 1, f"event seeds: {runner.captures} captures")
    for s, r in zip(seeds, sweep):
        single, _ = counted(ops, totals, lambda: run_scan(
            aggregator=make_rule(rule, dtype, 1), delays=delays(s), seed=s,
            **kw))
        check(np.array_equal(r.w, single.w) and np.array_equal(
            r.emit, single.emit) and np.array_equal(r.losses, single.losses)
            and np.array_equal(r.update_norms, single.update_norms),
            f"event seeds: seed {s} differs from its run_scan")
    print(f"engine event seeds {rule} {dtype}: seeds {seeds} on one capture "
          f"(runner.captures == 1), each bit-identical to its run_scan; "
          f"launches {counts} [{card}]")
    time_and_trace(torch, ops, "event ", kept, card)


def sanitize_phase(torch, ops, task, dev, card, totals, off_per_tick):
    """The sanitize checks on the card (int8 ACED K = 1, staleness engine,
    vision): checks on bit-identical to off, both graphs; the checks-off
    tick's device kernels phase 4's; off against on in turns and traced; a
    NaN params0 and a chunk whose carry holds an owner-ring slot of 9999
    raise the checks' errors, and the card runs on (no device assert)."""
    from repro_torch.convert import unravel
    from repro_torch.core import (make_chunked_staleness_runner,
                                  make_staleness_runner)
    rule, dtype, K = "aced", "int8", 1
    T, E = _depth(rule, K)
    streams, lr = engine_streams(task, K, E, dev), engine_lr(task, T)
    off = engine_runner(task, rule, dtype, K, T, dev,
                        checkify_invariants=False)
    on = engine_runner(task, rule, dtype, K, T, dev, checkify_invariants=True)
    (a, _), counts = counted(ops, totals, lambda: run_engine(
        torch, on, *streams, lr))
    b, _ = run_engine(torch, off, *streams, lr)
    check(same_run(torch, a, b), "checks on differ from checks off")
    records = {k: int(v) for k, v in on.carry["checks"].items()}
    check(all(v == -1 for v in records.values()), f"checks fired: {records}")
    print(f"sanitize {rule} {dtype} K={K}: checks on (graph) bit-identical "
          f"to off (graph): True; {len(records)} records, none fired: "
          f"{sorted(records)}; launches {counts} [{card}]")
    walls = [run_engine(torch, r, *streams, lr)[1] for r in (off, on, on, off)]
    ms = [1e3 * x / E for x in walls]
    print(f"engine A/B {rule} {dtype} K={K} checks: wall ms per tick off "
          f"{ms[0]:.4f}, on {ms[1]:.4f}, on {ms[2]:.4f}, off {ms[3]:.4f}; "
          f"arrivals/s {', '.join(f'{E / x:.1f}' for x in walls)} [{card}]")
    per_tick = {}
    for name, r, tick_ms, want in (("off", off, (ms[0] + ms[3]) / 2,
                                    off_per_tick),
                                   ("on", on, (ms[1] + ms[2]) / 2, None)):
        # checks off: phase 4's device kernels a tick, or it fails
        per_tick[name] = trace_engine(
            torch, ops, f"{rule} {dtype} K={K} checks {name} graph", r,
            (*streams, lr), E, tick_ms, card, per_tick_expected=want)[1]
    print(f"sanitize: device kernels a tick, checks off {per_tick['off']:.1f}"
          f" (phase 4: {off_per_tick:.1f}), on {per_tick['on']:.1f} [{card}]")

    nan = unravel(torch.full((D_SLICE,), float("nan"), device=dev),
                  task.params0)
    bad_run = make_staleness_runner(
        grad_fn=task.grad_fn, params0=nan,
        aggregator=make_rule(rule, dtype, K), n_clients=task.n_clients, T=T,
        beta=5.0, device=dev, checkify_invariants=True)
    raised = ""
    try:
        bad_run(*streams, lr)
    except RuntimeError as ex:
        raised = str(ex)
    check("non-finite server model" in raised,
          f"a NaN params0 gave {raised!r}")
    print(f"sanitize: NaN params0 raised {raised!r} [{card}]")

    rand, noise = streams
    half = E // 2 + 1
    cr = make_chunked_staleness_runner(
        capacity=half, grad_fn=task.grad_fn, params0=task.params0,
        aggregator=make_rule(rule, dtype, K), n_clients=task.n_clients, T=T,
        beta=5.0, device=dev, checkify_invariants=True)
    carry, _ = cr.chunk(cr.init(lr, noise.init), rand.slice(0, half),
                        noise.ticks[:half], lr)
    bad = {**carry, "state": {**carry["state"],
                              "ring": carry["state"]["ring"].clone()}}
    bad["state"]["ring"][0] = 9999
    raised = ""
    try:
        cr.chunk(bad, rand.slice(half, E), noise.ticks[half:], lr)
    except RuntimeError as ex:
        raised = str(ex)
    torch.cuda.synchronize()           # a device assert would surface here
    check("owner-ring slot out of bounds" in raised,
          f"a ring slot of 9999 gave {raised!r}")
    rest, _ = cr.chunk(carry, rand.slice(half, E), noise.ticks[half:], lr)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(rest["w"]).all()), "the clean chunk after it")
    print(f"sanitize: chunk 2 of a carry with owner-ring slot 0 = 9999 "
          f"raised {raised!r}; no device assert, and the clean carry's chunk "
          f"2 ran after it [{card}]")


# --- phase 4d: the host references ------------------------------------------

HOST_T = 100
# (rule, cache dtype, K, guarded (the fault study's schedule, the clip and
# resync every 10), the kernels its host run must launch)
HOST_RUNS = (("ace", "int8", 1, False, ("cache_row_update", "quantize_rows")),
             ("aced", "int8", 1, False, ("row_delta", "quantize_rows")),
             ("ca2fl", "int8", K_SLICE, False, ("commit_batch",)),
             ("ace", "int8", K_SLICE, True,
              ("commit_batch", "dequantize_rows", "quantize_rows")),
             ("aced_direct", "int8", 1, False,
              ("masked_agg", "quantize_rows")))
HOST_EVENT_RUNS = (("ace", "int8", ("cache_row_update", "quantize_rows")),
                   ("aced", "int8", ("row_delta", "quantize_rows")))


def host_agrees(torch, label, host_w, hr, engine_w, sr, uploads, card,
                walls, E):
    """The host run against the engine's: the final model within 1e-5,
    `ts`, client uploads and guard counters identical, losses and update
    norms within rtol 1e-4; prints whether the pair is bit-identical and
    the wall ms per tick of each run."""
    import numpy as np
    hw, ew = host_w.cpu().numpy(), engine_w.cpu().numpy()
    dev_w = float(np.abs(hw - ew).max())
    check(np.isfinite(hw).all() and dev_w <= 1e-5,
          f"{label}: host model {dev_w} from the graph run's")
    check(hr.ts == sr.ts.tolist(), f"{label}: ts differ")
    check(hr.total_comms == uploads, f"{label}: {hr.total_comms} uploads, "
          f"the graph run's {uploads}")
    check(hr.faults == sr.faults, f"{label}: guards {hr.faults} against "
          f"{sr.faults}")
    for name in ("losses", "update_norms"):
        a, b = np.asarray(getattr(hr, name)), getattr(sr, name)
        check(np.allclose(a, b, rtol=1e-4, atol=1e-6),
              f"{label}: {name} differ by {float(np.abs(a - b).max())}")
    same = bool((hw == ew).all() and hr.losses == sr.losses.tolist()
                and hr.update_norms == sr.update_norms.tolist())
    ms = {k: 1e3 * v / E for k, v in walls.items()}
    print(f"host {label}: {len(hr.ts)} updates, {hr.total_comms} uploads, "
          f"guards {hr.faults or 'off'}; final w max |host - graph| "
          f"{dev_w:.3e}, ts, uploads and guard counters identical, "
          f"bit-identical: {same}; wall ms per tick host {ms['host']:.4f}, "
          f"graph {ms['graph']:.4f} (first call, its capture and warm-up "
          f"tick included: {ms['graph_cold']:.4f}), eager "
          f"{ms['eager']:.4f} [{card}]")


def example_main(name):
    """The `main` of examples/<name>.py, loaded from its file."""
    import importlib.util
    path = ROOT / "examples" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"_example_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.main


def host_phase(torch, ops, task, dev, card, totals):
    """The host references on the card at the vision task's full width:
    `StalenessSimulator` in replay mode against the graph runner on the
    same streams (and fault schedule), `AFLSimulator` against the event
    engine's graph runner on `build_schedule`'s schedule, each host run's
    kernels launched; then the port's quickstart through its `main`."""
    from repro_torch.core import (AFLSimulator, ExponentialDelays,
                                  StalenessSimulator, build_fault_schedule,
                                  build_schedule, make_scan_runner)
    from repro_torch.core.aggregators import wants_cache_init
    from repro_torch.core.scan_engine import (_scan_result,
                                              build_payload_noise,
                                              default_n_events)
    from repro_torch.core.scan_staleness import _staleness_result
    n, T = task.n_clients, HOST_T
    lr = engine_lr(task, T)
    clip = clip_norm_of(torch, task, dev)
    print(f"host: vision task, n={n}, d={D_SLICE}, T={T}, lr {lr:.4f}, "
          f"seed 0's streams; guarded: rates {FAULT_RATES}, clip_norm "
          f"{clip:.6g}, resync every {RESYNC_EVERY} [{card}]")
    for rule, dtype, K, guarded, kernels in HOST_RUNS:
        label = f"{rule} {dtype} K={K}{' guarded' if guarded else ''}"
        agg = make_rule(rule, dtype, K)
        n_init = n if wants_cache_init(agg) else 0
        E = T - (1 if n_init else 0)     # every tick emits (K = 16: ≥ 10)
        rand, noise = engine_streams(task, K, E, dev)
        guard, statics = (), {}
        if guarded:
            guard = (build_fault_schedule(0, E, k_batch=K, device=dev,
                                          **FAULT_RATES), clip)
            statics = dict(guards=True, resync_every=RESYNC_EVERY)
        sim = StalenessSimulator(
            grad_fn=task.grad_fn, params0=task.params0, aggregator=agg,
            n_clients=n, server_lr=lr, beta=5.0, seed=0, replay=rand,
            payload_noise=noise, k_batch=K,
            faults=guard[0] if guard else None,
            clip_norm=guard[1] if guard else 0.0, device=dev,
            resync_every=statics.get("resync_every"))
        (hr, host_s), counts = counted(ops, totals, lambda: run_engine(
            torch, sim.run, T))
        for kernel in kernels:
            check(counts[kernel] > 0, f"host {label}: {kernel} was not "
                  "launched")
        runner = engine_runner(task, rule, dtype, K, T, dev, **statics)
        eager = engine_runner(task, rule, dtype, K, T, dev, graph=False,
                              **statics)
        walls = {"host": host_s}
        for key, r in (("graph_cold", runner), ("graph", runner),
                       ("eager", eager)):
            (run, walls[key]), _ = counted(ops, totals, lambda: run_engine(
                torch, r, rand, noise, lr, *guard))
        check(runner.captures == 1, f"host {label}: {runner.captures} "
              "captures")
        sr = _staleness_result(run, T, n_init, None, None, task.params0)
        # the engine counts a tick, the host (as JAX's) a live lane: here
        # every lane of every tick is live
        uploads = n_init + K * (sr.total_comms - n_init)
        host_agrees(torch, label, sim.w, hr, run[0], sr, uploads, card,
                    walls, E)
        if guarded:
            check(min(hr.faults.values()) > 0, f"host {label}: a guard never "
                  f"fired: {hr.faults}")

    kw = dict(grad_fn=task.grad_fn, params0=task.params0, n_clients=n,
              server_lr=lr, device=dev)

    def delays():
        return ExponentialDelays(beta=5.0, kappa=EVENT_KAPPA, n_clients=n,
                                 seed=0)
    for rule, dtype, kernels in HOST_EVENT_RUNS:
        label = f"event {rule} {dtype}"
        E = default_n_events(make_rule(rule, dtype, 1), T)
        sim = AFLSimulator(aggregator=make_rule(rule, dtype, 1),
                           delays=delays(), seed=0, **kw)
        (hr, host_s), counts = counted(ops, totals, lambda: run_engine(
            torch, sim.run, T))
        for kernel in kernels:
            check(counts[kernel] > 0, f"host {label}: {kernel} was not "
                  "launched")
        sched = build_schedule(delays(), E, None, 0)
        args = (sched.arrive, sched.dispatch,
                build_payload_noise(task.grad_fn, 0, E, n, device=dev))
        walls = {"host": host_s}
        runner = make_scan_runner(aggregator=make_rule(rule, dtype, 1), T=T,
                                  **kw)
        eager = make_scan_runner(aggregator=make_rule(rule, dtype, 1), T=T,
                                 graph=False, **kw)
        for key, r in (("graph_cold", runner), ("graph", runner),
                       ("eager", eager)):
            (run, walls[key]), _ = counted(ops, totals, lambda: run_engine(
                torch, r, *args))
        sr = _scan_result(run, T, n if wants_cache_init(sim.agg) else 0)
        host_agrees(torch, label, sim.w, hr, run[0], sr, sr.total_comms,
                    card, walls, E)

    # the port's front door: examples/torch_quickstart.py on the card
    (runs, wall), counts = counted(ops, totals, lambda: run_engine(
        torch, example_main("torch_quickstart"), dev))
    uploads = [r.total_comms for _, r in runs.values()]
    check(uploads == [319, 300], f"quickstart: uploads {uploads}, not "
          "[319, 300]")
    for name, (sim, r) in runs.items():
        check(bool(torch.isfinite(sim.w).all()), f"quickstart {name}: "
              "non-finite model")
        acc = r.final_eval()["accuracy"]
        check(acc > 0.5, f"quickstart {name}: accuracy {acc} (chance 0.1)")
    check(counts["cache_row_update"] > 0, "quickstart: ACE int8 launched no "
          "cache_row_update")
    print(f"host quickstart (examples/torch_quickstart.py): {wall:.2f} s, "
          f"uploads {uploads}, final accuracies "
          f"{[round(r.final_eval()['accuracy'], 4) for _, r in runs.values()]}"
          f"; launches {counts} [{card}]")


# --- phase 4e: the tree layout ---------------------------------------------

# the tree runs at K = 1 (each f32 one against phase 4's flat run), then
# int8 ACE at K = 16, and those timed and traced beside phase 4's flat ones
TREE_RUNS = ([(rule, dtype, 1) for rule in ("ace", "aced", "ca2fl")
              for dtype in ("int8", "float32")] + [("ace", "int8", K_SLICE)])
TREE_TIMED = (("ace", "int8", 1), ("aced", "int8", 1))
# what a tree run launches: every int8 leaf write quantizes, every read
# dequantizes (an f32 tree with an f32 ring launches no kernel)
TREE_KERNELS = ("quantize_rows", "dequantize_rows")


def tree_leaf_kernels(torch, ops, tasks, rows, dev, card, timed_from=None):
    """quantize_rows and dequantize_rows at every ``(rows, numel)`` view the
    tree layout hands them: each leaf of each task's parameters, by one
    arriving row, a K-lane batch, the client count (the int8 init, the
    means, the resync) and the history ring's tau_max + 1 rows; q, s and
    the dequantized rows bit-identical to the plain versions (the all-zero
    row, the half-way ties and the offsets of `compare_quant` /
    `compare_dequant` included). quantize_rows is timed (`LEAF_ITERS`
    calls) at every view of a leaf of `timed_from` numbers or more."""
    from repro_torch.convert import leaves
    numels = sorted({x.numel() for t in tasks for x in leaves(t.params0)})
    for d in numels:
        for n in rows:
            timed = timed_from is not None and d >= timed_from
            compare_quant(torch, ops, n, d, dev, card, timed=timed,
                          quiet=not timed, iters=LEAF_ITERS)
            compare_dequant(torch, ops, n, d, dev, card, timed=False,
                            quiet=True)
    print(f"kernel quantize_rows, dequantize_rows at the tree's leaf views: "
          f"bit-identical to the plain versions at rows {list(rows)} × "
          f"numel {numels} [{card}]")


def tree_plain(torch, ops, label, make, args, ref, card):
    """The run of `ref` again eagerly with the rule's ``backend="torch"``
    (`make(False, "torch")`: the plain versions in the rule's caches and in
    the history ring): no kernel launched, the final model within 1e-4
    (relative) of the kernels' run."""
    from repro_torch.convert import ravel
    plain = make(False, "torch")
    ops.reset_launch_counts()
    out, wall = run_engine(torch, plain, *args)
    check(sum(ops.launch_counts().values()) == 0,
          f"{label}: backend='torch' launched a kernel")
    w, w_ref = ravel(out[0]), ravel(ref[0])
    dev_w = float((w - w_ref).abs().max() / w_ref.abs().max().clamp(
        min=1e-12))
    check(dev_w <= 1e-4, f"{label}: plain run deviates {dev_w}")
    print(f"engine {label} plain versions (eager): {wall:.2f} s, final w "
          f"within {dev_w:.3e} (relative) of the kernels' run, the run "
          f"bit-identical: {same_run(torch, out, ref)} [{card}]")


def tree_run(torch, ops, totals, label, make, args, must):
    """One tree configuration through the graph runner (`make(graph)`) and
    again eagerly: bit for bit (model and caches leaf by leaf), one
    capture, the kernels in `must` launched, a finite model -> (graph
    runner, eager runner, the run, launch counts, graph s, eager s)."""
    runner = make(None)
    (out, wall), counts = counted(ops, totals, lambda: run_engine(
        torch, runner, *args))
    check(runner.captures == 1, f"{label}: {runner.captures} captures")
    for kernel in must:
        check(counts[kernel] > 0, f"{label}: {kernel} was not launched")
    check(all(bool(torch.isfinite(x).all()) for x in tensors_of(out[0])),
          f"{label}: non-finite model")
    eager = make(False)
    ref, wall_e = run_engine(torch, eager, *args)
    check(same_run(torch, out, ref), f"{label}: the graph run differs from "
          "the eager run")
    return runner, eager, out, counts, wall, wall_e


def tree_phase(torch, ops, task, dev, card, totals, flat_w, flat_tick,
               flat_ms, flat_guards):
    """The tree layout (`layout="tree"`) on the card: the vision task at
    full width (n = 100, d = 17,226 over six leaves, 300 ticks) for ACE,
    ACED and CA²FL with int8 and f32 tree caches at K = 1 (each f32 run
    within 1e-5 of phase 4's flat run on the same streams), int8 ACE at K
    = 16, int8 ACE with an int8 history ring, int8 ACED faulted with the
    clip and resync every 10 (every guard fired, the counters beside the
    flat run's), and the text task (d = 70,996, the 1024 × 64 embedding a
    leaf) for int8 ACE K = 1; every graph run bit-identical to its eager
    run, accuracy above 0.5 (text: 0.10), and the int8-ring and text runs
    again with the plain versions (within 1e-4); quantize_rows and
    dequantize_rows first held against their plain versions at every leaf
    view the phase gives them; then int8 ACE and ACED K = 1 timed eager,
    graph, graph, eager and traced, quantize_rows and dequantize_rows seen
    in the replays as often as their counters count, printed beside phase
    4's flat numbers."""
    import numpy as np
    from repro_torch.convert import leaves, ravel
    from repro_torch.core import build_fault_schedule, make_text_task
    from repro_torch.core.staleness_sim import default_tau_max
    n_leaves = len(leaves(task.params0))
    check(n_leaves == 6, f"the vision MLP has {n_leaves} leaves, not 6")
    print(f"engine tree: vision task, n={task.n_clients}, d={D_SLICE} over "
          f"{n_leaves} leaves {[tuple(x.shape) for x in leaves(task.params0)]}"
          f" [{card}]")
    text = make_text_task(device=dev)
    tree_leaf_kernels(torch, ops, (task, text), sorted(
        {1, K_SLICE, task.n_clients, text.n_clients,
         default_tau_max(5.0) + 1}), dev, card)
    kept = {}
    for rule, dtype, K in TREE_RUNS:
        T, E = _depth(rule, K)
        label = f"tree {rule} {dtype} K={K}"
        streams, lr = engine_streams(task, K, E, dev), engine_lr(task, T)
        runner, eager, out, counts, wall, wall_e = tree_run(
            torch, ops, totals, label,
            lambda g: engine_runner(task, rule, dtype, K, T, dev, graph=g,
                                    layout="tree"),
            (*streams, lr), TREE_KERNELS if dtype == "int8" else ())
        acc = task.eval_fn(out[0])["accuracy"]
        check(acc > 0.5, f"{label}: accuracy {acc} (chance 0.1)")
        note = ""
        if dtype == "float32":
            w, ref = ravel(out[0]).cpu().numpy(), flat_w[rule, dtype, K]
            dw = float(np.abs(w - ref).max())
            check(dw <= 1e-5 * max(1.0, float(np.abs(ref).max())),
                  f"{label}: {dw} from the flat run")
            note = f"; final w max |tree - flat| {dw:.3e}"
        print(f"engine {label}: T={T}, {E} ticks, "
              f"{int(out[2]['emit'].sum())} updates, accuracy {acc:.4f}"
              f"{note}; graph run {wall:.2f} s with its capture, eager run "
              f"{wall_e:.2f} s; graph and eager bit-identical: True; "
              f"launches {counts} [{card}]")
        if (rule, dtype, K) in TREE_TIMED:
            kept[rule, dtype, K] = (runner, eager, (*streams, lr), E, K)

    # the int8 history ring: every stale read dequantizes, every append
    # quantizes, leaf by leaf
    rule, dtype, K = "ace", "int8", 1
    T, E = _depth(rule, K)
    streams, lr = engine_streams(task, K, E, dev), engine_lr(task, T)
    label = "tree ace int8 K=1, int8 history ring"

    def make(g, b=None):
        return engine_runner(task, rule, dtype, K, T, dev, backend=b,
                             graph=g, layout="tree", history_dtype="int8")
    _, _, out, counts, wall, wall_e = tree_run(
        torch, ops, totals, label, make, (*streams, lr), TREE_KERNELS)
    acc = task.eval_fn(out[0])["accuracy"]
    check(acc > 0.5, f"{label}: accuracy {acc}")
    print(f"engine {label}: accuracy {acc:.4f}; graph run {wall:.2f} s, "
          f"eager run {wall_e:.2f} s; graph and eager bit-identical: True; "
          f"launches {counts} [{card}]")
    tree_plain(torch, ops, label, make, (*streams, lr), out, card)

    # faulted, the clip and resync every 10, against the flat run's counters
    rule, dtype, K = "aced", "int8", 1
    T, E = _depth(rule, K)
    streams, lr = engine_streams(task, K, E, dev), engine_lr(task, T)
    clip = clip_norm_of(torch, task, dev)
    faults = build_fault_schedule(0, E, k_batch=K, device=dev, **FAULT_RATES)
    label = f"tree {rule} {dtype} K={K} faulted, resync every {RESYNC_EVERY}"
    _, _, out, counts, wall, wall_e = tree_run(
        torch, ops, totals, label,
        lambda g: engine_runner(task, rule, dtype, K, T, dev, graph=g,
                                layout="tree", guards=True,
                                resync_every=RESYNC_EVERY),
        (*streams, lr, faults, clip), TREE_KERNELS)
    guards = {k: int(v) for k, v in out[3]["guards"].items()}
    check(all(v > 0 for v in guards.values()),
          f"{label}: a guard never fired: {guards}")
    acc = task.eval_fn(out[0])["accuracy"]
    check(acc > 0.5, f"{label}: accuracy {acc}")
    print(f"engine {label}: guard counters {guards} (flat, phase 4b: "
          f"{flat_guards[rule, dtype, K]}), accuracy {acc:.4f}; graph run "
          f"{wall:.2f} s, eager run {wall_e:.2f} s; graph and eager "
          f"bit-identical: True; launches {counts} [{card}]")

    # the text task: the embedding is a leaf of 1024 × 64
    d_text = ravel(text.params0).numel()
    check(d_text == D_TEXT, f"text task has d={d_text}, expected {D_TEXT}")
    rule, dtype, K = "ace", "int8", 1
    T, E = _depth(rule, K)
    streams = engine_streams(text, K, E, dev)
    lr = 3.0 * float(np.sqrt(text.n_clients / T))
    label = "tree text ace int8 K=1"

    def make_text(g, b=None):
        return engine_runner(text, rule, dtype, K, T, dev, backend=b,
                             graph=g, layout="tree")
    _, _, out, counts, wall, wall_e = tree_run(
        torch, ops, totals, label, make_text, (*streams, lr), TREE_KERNELS)
    acc = text.eval_fn(out[0])["accuracy"]
    check(acc > 0.10, f"{label}: accuracy {acc} (chance 0.05)")
    print(f"engine {label}: n={text.n_clients}, d={D_TEXT}, leaves "
          f"{ {k: tuple(v.shape) for k, v in text.params0.items()} }, "
          f"accuracy {acc:.4f}; graph run {wall:.2f} s, eager run "
          f"{wall_e:.2f} s; graph and eager bit-identical: True; launches "
          f"{counts} [{card}]")
    tree_plain(torch, ops, label, make_text, (*streams, lr), out, card)

    per_tick, tree_ms = time_and_trace(torch, ops, "tree ", kept, card,
                                       must=TREE_KERNELS)
    for key in TREE_TIMED:
        rule, dtype, K = key
        print(f"engine tree vs flat {rule} {dtype} K={K}: graph wall ms a "
              f"tick {tree_ms[key]:.4f} vs {flat_ms[key]:.4f}, device "
              f"kernels a tick {per_tick[key]:.1f} vs {flat_tick[key]:.1f} "
              f"[{card}]")


# --- phase 4f: the real models -----------------------------------------------

# 4f: yi-9b's published widths (arXiv:2403.04652: d_model 4,096, 32 heads, 4
# kv heads, head_dim 128, d_ff 11,008, vocab 64,000) cut in depth from 48
# layers to 1; 4g: zamba2-1.2b's (arXiv:2411.15242: d_model 2,048, 32 heads,
# 32 kv heads, head_dim 64, d_ff 8,192, ssm_state 64, d_inner 4,096 as 64
# SSM heads of 64, conv 4, chunk 256, window 4,096, vocab 32,000) cut from 38
# layers to 7: one repeat of its (mamba ×5, shared_attn) unit and one of its
# (mamba,) stage, so two stages and the model-level shared block. Both on
# the LM task at launch/train.py's defaults (n = 8 clients, batch 8, seq 256
# — one SSD chunk —, 2^18 tokens; beta = 5, so tau_max = 50 and a ring of 51
# rows; lr = sqrt_nt_schedule(0.5, 8, 200) = 0.1, the first 12 ticks: 24
# until phase 4k came, which took the time this half gives back), with int8
# tree caches and an int8 history ring
LM_TASK = dict(n_clients=8, batch=8, seq=256, n_tokens=1 << 18, seed=0)
LM_STEPS, LM_TICKS, LM_LR_SCALE = 200, 12, 0.5
# phase: (arch, leaves, numbers, reckoned peak GB allocated, decode from a
# prefill's K/V — an SSM keeps no prefill state, so 4g decodes from the
# start)
LM_CUTS = {"4f": ("yi-9b", 11, 435171328, "45-50", True),
           "4g": ("zamba2-1.2b", 65, 286169984, "25-40", False)}
LM_DECODE = 16                          # prompt and decode steps (a)
# (rule, K): ACE, and ACED with a cohort ring of 3 (tests/test_k_batch.py)
LM_RUNS = (("ace", 1), ("aced", 3))
# kernel groups of the traced tick: cuBLAS's matrix products, the
# embedding's backward (a sort and segment sums) and the quant kernels
LM_GROUPS = {"matrix products": r"gemm",
             "embedding backward": r"embedding|segment|grad_weight|"
                                   r"sum_and_scatter|radixsort",
             "quant kernels": r"quantize_rows_(grid_)?kernel|"
                              r"dequantize_rows_kernel"}


def lm_config(phase):
    """The configuration a phase runs: its arch at its published widths,
    cut in depth (`LM_CUTS`)."""
    import dataclasses
    from repro_torch.configs.base import ATTN, MAMBA, SHARED_ATTN
    from repro_torch.configs.registry import get_config
    stages = {"4f": (((ATTN,), 1),),
              "4g": (((MAMBA,) * 5 + (SHARED_ATTN,), 1), ((MAMBA,), 1))}
    return dataclasses.replace(
        get_config(LM_CUTS[phase][0]), stages=stages[phase],
        num_layers=sum(len(p) * r for p, r in stages[phase]))


def lm_runner(task, rule, K, dev, graph, backend=None):
    """The tree-layout runner of one LM configuration: int8 tree caches and
    an int8 history ring."""
    from repro_torch.core import ACED, ACEIncremental, make_staleness_runner
    agg = (ACEIncremental(cache_dtype="int8", backend=backend) if rule == "ace"
           else ACED(tau_algo=5, cache_dtype="int8", max_cohort=K,
                     backend=backend))
    return make_staleness_runner(
        grad_fn=task.grad_fn, params0=task.params0, aggregator=agg,
        n_clients=task.n_clients, T=LM_STEPS, beta=5.0, k_batch=K,
        device=dev, graph=graph, layout="tree", history_dtype="int8")


def free(torch):
    import gc
    gc.collect()
    torch.cuda.empty_cache()


def lm_decode_check(torch, params, cfg, dev, card, prefill=True, P=None,
                    label="lm"):
    """With `prefill`, prefill a prompt of P = `LM_DECODE` tokens, carry its
    K/V into a decode cache and decode P more; else decode all 2P from
    `init_cache` (an SSM's prefill returns no state): the prefill's last
    logits and every decode step's against the forward pass over all the
    tokens, within 3e-3 of max(1, max|logits|) (tests/test_models.py's
    tolerance)."""
    from repro_torch.models import build_model
    model, P, B = build_model(cfg), P or LM_DECODE, 2
    gen = torch.Generator(device=dev).manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (B, 2 * P), generator=gen,
                         device=dev, dtype=torch.int32)
    start = P if prefill else 0
    with torch.no_grad():
        logits, _ = model.forward(params, {"tokens": toks})
        cache = model.init_cache(B, 2 * P, device=dev)
        err = 0.0
        if prefill:
            last, kv = model.prefill(params, {"tokens": toks[:, :P]})
            err = float((last - logits[:, P - 1]).abs().max())
            for stage, filled in zip(cache["layers"], kv):
                for block, (k, v) in zip(stage, filled):
                    block["k"][:, :, :P] = k
                    block["v"][:, :, :P] = v
        steps = []
        for t in range(start, 2 * P):
            lg, cache = model.decode_step(params, cache, toks[:, t], t)
            steps.append(lg)
    scale = max(1.0, float(logits.abs().max()))
    err = max(err, float((torch.stack(steps, 1)
                          - logits[:, start:]).abs().max()))
    check(err <= 3e-3 * scale, f"{label}: decode differs from forward by "
          f"{err}")
    how = (f"prefill of {P} tokens then {P} decode steps" if prefill
           else f"{2 * P} decode steps from init_cache")
    print(f"{label} decode: {how} (B={B}) against the forward pass over "
          f"{2 * P}: max |diff| {err:.3e} (logits up to {scale:.3f}; "
          f"tolerance 3e-3) [{card}]")


def lm_phase(torch, ops, dev, card, totals, phase="4f"):
    """The phase's model at its published widths, cut in depth
    (`lm_config`: 4f yi-9b at one layer, 4g zamba2-1.2b at 7), on the LM
    task (`LM_TASK`) through the tree layout: (a) the model's leaves and
    numbers (`LM_CUTS`), the eval loss at w0 within 0.5 of ln vocab and
    decode against forward; (d) quantize_rows and dequantize_rows against
    their plain versions at every leaf view of the tree by 1 and 8 rows,
    quantize_rows timed at the views of 2^20 numbers or more,
    dequantize_rows at the embedding's one row; (b) ACE int8 K = 1 and
    ACED int8 K = 3 (int8 tree caches, an int8 ring, 12 ticks), each graph
    run bit
    for bit with its eager run (model, caches, outputs), finite, both
    quant kernels launched, eval losses at w0 and at the end, peak memory;
    (c) ACE again with the plain versions (no kernel, within 1e-4); (e)
    ACE timed eager, graph, graph, eager (the graph runner captured
    before) and one graph run traced. Only the first run's model and
    caches are kept between compared runs: a runner's carry (4f: the 22 GB
    int8 ring) is freed before the next one is built. Returns (the task,
    the traced ACE tick's device busy ms)."""
    import math
    from repro_torch.configs.registry import get_config
    from repro_torch.convert import leaves, tree_map
    from repro_torch.core import make_lm_task
    from repro_torch.optim import sqrt_nt_schedule

    arch, n_leaves, n_numel, reckoned, prefill = LM_CUTS[phase]
    cfg = lm_config(phase)
    t0 = time.perf_counter()
    task = make_lm_task(cfg=cfg, device=dev, **LM_TASK)
    torch.cuda.synchronize()
    built = time.perf_counter() - t0
    shapes = [tuple(x.shape) for x in leaves(task.params0)]
    numel = sum(x.numel() for x in leaves(task.params0))
    check(len(shapes) == n_leaves and numel == n_numel,
          f"{len(shapes)} leaves, {numel} numbers: expected {n_leaves}, "
          f"{n_numel}")
    loss0 = task.eval_fn(task.params0)["loss"]
    check(abs(loss0 - math.log(cfg.vocab_size)) < 0.5,
          f"eval loss at w0 {loss0}, ln vocab {math.log(cfg.vocab_size)}")
    widths = (f"d_model {cfg.d_model}, {cfg.num_heads} heads, "
              f"{cfg.num_kv_heads} kv heads, head_dim {cfg.head_dim}, d_ff "
              f"{cfg.d_ff}, vocab {cfg.vocab_size}")
    if cfg.ssm_state:
        widths += (f", ssm_state {cfg.ssm_state}, d_inner {cfg.d_inner} "
                   f"({cfg.ssm_heads} SSM heads of {cfg.ssm_head_dim}), "
                   f"conv {cfg.ssm_conv}, chunk {cfg.ssm_chunk}, window "
                   f"{cfg.window_size}")
    largest = max(x.numel() for x in leaves(task.params0))
    print(f"lm {phase}: {cfg.name} at its published widths, "
          f"{cfg.num_layers} of {get_config(arch).num_layers} layers, stages "
          f"{cfg.stages} ({widths}); {len(shapes)} leaves, {numel} numbers "
          f"({4 * numel / 1e9:.3f} GB f32), the largest {largest}; "
          f"param_count() {cfg.param_count()} (an untied unembedding it "
          f"counts is not built, ROADMAP C10); task built in {built:.1f} s; "
          f"eval loss at w0 {loss0:.4f} (ln vocab "
          f"{math.log(cfg.vocab_size):.4f}) [{card}]")
    lm_decode_check(torch, task.params0, cfg, dev, card, prefill=prefill,
                    label=f"lm {phase}")

    # (d) the quant kernels at every (rows, numel) view the runs give them,
    # quantize_rows timed at every view of a leaf of 2^20 numbers or more
    # (the grid's), dequantize_rows at the embedding leaf's one row (a
    # cache row or ring write, a ring read)
    tree_leaf_kernels(torch, ops, (task,), (1, LM_TASK["n_clients"]), dev,
                      card, timed_from=1 << 20)
    embed = task.params0["embed"]["embedding"].numel()
    compare_dequant(torch, ops, 1, embed, dev, card)
    free(torch)

    lr = sqrt_nt_schedule(LM_LR_SCALE, LM_TASK["n_clients"], LM_STEPS)(0)
    E = LM_TICKS

    def one(label, runner, args, count=True):
        """One runner call, its launches added to the totals -> (out, wall
        s, counts, (peak GB allocated, peak GB reserved))."""
        torch.cuda.reset_peak_memory_stats(dev)
        if count:
            (out, wall), counts = counted(ops, totals, lambda: run_engine(
                torch, runner, *args))
        else:
            (out, wall), counts = run_engine(torch, runner, *args), {}
        peak = (torch.cuda.max_memory_allocated(dev) / 1e9,
                torch.cuda.max_memory_reserved(dev) / 1e9)
        print(f"  {label}: {wall:.2f} s, {1e3 * wall / E:.1f} ms a tick, "
              f"peak {peak[0]:.2f} GB allocated, {peak[1]:.2f} GB reserved "
              f"(a graph's pool counts as reserved) [{card}]")
        return out, wall, counts, peak

    def host(out):
        """A run's result moved to the host (its device copy freed): the
        compared runs' results wait there, out of the next run's way."""
        return tree_map(lambda x: x.cpu(), out)

    def check_out(label, out):
        check(all(bool(torch.isfinite(x).all()) for x in leaves(out[0])),
              f"{label}: non-finite model")
        check(bool(torch.isfinite(out[2]["loss"]).all()),
              f"{label}: non-finite loss")

    busy_ms = None
    for rule, K in LM_RUNS:
        label = f"lm {phase} {rule} int8 K={K}"
        args = (*engine_streams(task, K, E, dev), lr)
        ref, wall_e, counts_e, peak_e = one(f"{label} eager", lm_runner(
            task, rule, K, dev, False), args)
        check_out(label, ref)
        ref = host(ref)
        for kernel in TREE_KERNELS:
            check(counts_e[kernel] > 0, f"{label}: {kernel} not launched")
        free(torch)
        graph = lm_runner(task, rule, K, dev, None)
        out, wall_g, counts_g, peak_g = one(f"{label} graph (with its "
                                            f"capture)", graph, args)
        check(graph.captures == 1, f"{label}: {graph.captures} captures")
        if rule != "ace":
            # only ACE's runner is timed below: free its carry and the
            # graph's pool (28 GiB at K = 3)
            del graph
        out = host(out)
        free(torch)
        check(same_run(torch, out, ref), f"{label}: the graph run differs "
              "from the eager run")
        for kernel in TREE_KERNELS:
            check(counts_g[kernel] > 0, f"{label}: {kernel} not launched")
        del out
        loss_end = task.eval_fn(tree_map(lambda x: x.to(dev), ref[0]))[
            "loss"]
        check(math.isfinite(loss_end), f"{label}: eval loss {loss_end}")
        print(f"engine {label}: {E} ticks, "
              f"{int(ref[2]['emit'].sum())} updates, eval loss {loss0:.4f} "
              f"at w0 -> {loss_end:.4f}; graph and eager bit-identical "
              f"(model, int8 caches and scales, running sums, outputs): "
              f"True; launches graph {counts_g}, eager {counts_e}; peak "
              f"{peak_g[0]:.2f} / {peak_e[0]:.2f} GB allocated, "
              f"{peak_g[1]:.2f} / {peak_e[1]:.2f} GB reserved (graph / "
              f"eager; reckoned {reckoned}) [{card}]")
        if rule != "ace":
            del ref
            free(torch)
            continue
        # (e) graph, graph with the captured runner, traced, then eager
        walls = [wall_e]
        for _ in range(2):
            again, wall, _, _ = one(f"{label} graph", graph, args,
                                    count=False)
            check(same_run(torch, host(again), ref), f"{label}: a replayed "
                  "run differs from the eager run")
            walls.append(wall)
            del again
            free(torch)
        tick_ms = 1e3 * (walls[1] + walls[2]) / 2 / E
        busy_ms, _ = trace_engine(torch, ops, f"{label} graph", graph, args,
                                  E, tick_ms, card, must=TREE_KERNELS,
                                  top=10, groups=LM_GROUPS)
        del graph
        free(torch)
        again, wall, _, _ = one(f"{label} eager", lm_runner(
            task, rule, K, dev, False), args, count=False)
        check(same_run(torch, host(again), ref),
              f"{label}: two eager runs differ")
        walls.append(wall)
        del again
        free(torch)
        ms = [1e3 * x / E for x in walls]
        print(f"engine A/B {label}: wall ms per tick eager {ms[0]:.2f}, "
              f"graph {ms[1]:.2f}, graph {ms[2]:.2f}, eager {ms[3]:.2f}; "
              f"arrivals/s {', '.join(f'{E * K / x:.2f}' for x in walls)} "
              f"[{card}]")
        # (c) the plain versions: no kernel, within 1e-4
        plain, wall, counts, _ = one(f"{label} plain versions (eager)",
                                     lm_runner(task, rule, K, dev, False,
                                               backend="torch"), args)
        check(sum(counts.values()) == 0,
              f"{label}: backend='torch' launched a kernel")
        plain = host(plain)
        top = max(float(x.abs().max()) for x in leaves(ref[0]))
        dev_w = max(float((a - b).abs().max()) for a, b in
                    zip(leaves(plain[0]), leaves(ref[0]))) / max(top, 1e-12)
        check(dev_w <= 1e-4, f"{label}: plain run deviates {dev_w}")
        print(f"engine {label} plain versions (eager): {wall:.2f} s, final "
              f"w within {dev_w:.3e} (relative) of the kernels' run, "
              f"bit-identical: {same_run(torch, plain, ref)} [{card}]")
        del plain, ref
        free(torch)
    return task, busy_ms


# --- phase 4g: the rest of the real models ------------------------------------

# (e) one forward each at the published widths: mamba2-780m at all 48 layers
# (arXiv:2405.21060), qwen3-moe-235b-a22b at one of 94 layers (128 experts,
# top-8), seamless-m4t-medium at full depth (12 + 12 layers)
WIDE_NUMEL = {"mamba2-780m": 780148992, "qwen3-moe-235b-a22b": 3110088960,
              "seamless-m4t-medium": 715403264}
# the SSD scan at mamba2's head shapes: (H, P, N, G), two chunks of 256
SSD_SHAPES, SSD_L = (48, 64, 128, 1), 512
# the capacity factor of the MoE's decode-against-forward comparison only:
# no token drops in either grouping (C >= L in the forward, C >= B in
# decode); at the published 1.25 the forward (G = B) and decode (G = 1)
# drop different tokens, in JAX too
MOE_DECODE_CAPACITY = 16.0


def ssd_share(torch, cfg, dev, card, busy_ms):
    """`ssd_chunked` forward and backward at one lane's shapes (batch 8,
    seq 256, zamba2's 64 heads of 64, state 64), CUDA-event ms a call,
    times the cut's mamba layers, against the traced ACE tick's device
    busy ms (one lane a tick): the SSD's share of the tick. The trace
    cannot tell its batched products from the projections' (both are
    cuBLAS gemm kernels, replayed from one graph), so it is timed alone."""
    from repro_torch.configs.base import MAMBA
    from repro_torch.models.ssm import ssd_chunked
    B, L = LM_TASK["batch"], LM_TASK["seq"]
    H, P, N, G = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, \
        cfg.ssm_groups
    g = torch.Generator(device=dev).manual_seed(5)
    xs = [torch.randn(s, generator=g, device=dev) * 0.1 for s in
          ((B, L, H, P), (B, L, H), (B, L, G, N), (B, L, G, N))]
    xs[1] = -xs[1].abs()
    xs = [x.requires_grad_(True) for x in xs]

    def call():
        y, final = ssd_chunked(*xs, cfg)
        torch.autograd.grad(y.sum() + final.sum(), xs)
    _, ms, _ = measure(torch, call, 20)
    layers = sum(p.count(MAMBA) * r for p, r in cfg.stages)
    share = layers * ms / busy_ms if busy_ms else float("nan")
    print(f"lm 4g ssd_chunked forward and backward at a lane's shapes (B={B}, "
          f"L={L}, H={H}, P={P}, N={N}, G={G}): {ms:.4f} ms (CUDA events) × "
          f"{layers} mamba layers = {layers * ms:.3f} ms, {share:.3f} of the "
          f"traced ACE tick's {busy_ms:.3f} ms device busy time [{card}]")


def _ssd_recurrence(torch, x, a, Bm, Cm):
    """tests/test_ssm.py's step recurrence (`naive_ssd`) in float64 on the
    card -> (y, final state)."""
    Bsz, L, H, P = x.shape
    Hg = H // Bm.shape[2]
    x, a, Bm, Cm = (t.double() for t in (x, a, Bm, Cm))
    h = torch.zeros((Bsz, H, P, Bm.shape[3]), dtype=torch.float64,
                    device=x.device)
    ys = []
    for t in range(L):
        h = h * torch.exp(a[:, t])[:, :, None, None]
        bb = Bm[:, t].repeat_interleave(Hg, dim=1)
        cc = Cm[:, t].repeat_interleave(Hg, dim=1)
        h = h + x[:, t][..., None] * bb[:, :, None, :]
        ys.append(torch.einsum("bhpn,bhn->bhp", h, cc))
    return torch.stack(ys, 1), h


def _numel_check(torch, label, params, expected, card):
    from repro_torch.convert import leaves
    numel = sum(x.numel() for x in leaves(params))
    check(numel == expected, f"{label}: {numel} numbers, expected "
          f"{expected}")
    print(f"{label}: {len(leaves(params))} leaves, {numel} numbers "
          f"({4 * numel / 1e9:.2f} GB f32) [{card}]")


def wide_phase(torch, dev, card):
    """(e) At the published widths, one model at a time (memory freed
    between them): mamba2-780m at all 48 layers, decode from `init_cache`
    against forward over 32 tokens, and `ssd_chunked` at its head shapes
    over two chunks against the step recurrence; qwen3-moe-235b-a22b at
    one layer, loss and gradient at B = 2, L = 16 (finite, two gradients
    of one batch bit for bit: the MoE sums in no order the card picks),
    then decode against forward at capacity factor `MOE_DECODE_CAPACITY`;
    seamless-m4t-medium at full depth, forward and loss on source frames
    (finite) and three decode steps (finite)."""
    import dataclasses
    import math
    from repro_torch.configs.base import ATTN
    from repro_torch.configs.registry import get_config
    from repro_torch.convert import _rebuild, leaves
    from repro_torch.models import build_model
    from repro_torch.models.ssm import ssd_chunked

    t0 = time.perf_counter()
    cfg = get_config("mamba2-780m")
    params = build_model(cfg).init(torch.Generator(device=dev).manual_seed(0))
    _numel_check(torch, f"wide {cfg.name} ({cfg.num_layers} layers)", params,
                 WIDE_NUMEL[cfg.name], card)
    lm_decode_check(torch, params, cfg, dev, card, prefill=False,
                    label=f"wide {cfg.name}")
    del params
    free(torch)
    H, P, N, G = SSD_SHAPES
    g = torch.Generator(device=dev).manual_seed(6)
    x = torch.randn((2, SSD_L, H, P), generator=g, device=dev) * 0.5
    a = -torch.randn((2, SSD_L, H), generator=g, device=dev).abs() * 0.3
    Bm, Cm = (torch.randn((2, SSD_L, G, N), generator=g, device=dev) * 0.5
              for _ in range(2))
    ssd_cfg = dataclasses.replace(cfg, ssm_chunk=SSD_L // 2)
    with torch.no_grad():
        y, final = ssd_chunked(x, a, Bm, Cm, ssd_cfg)
    ref_y, ref_h = _ssd_recurrence(torch, x, a, Bm, Cm)
    err = max(float((y.double() - ref_y).abs().max()),
              float((final.double() - ref_h).abs().max()))
    scale = max(1.0, float(ref_y.abs().max()), float(ref_h.abs().max()))
    check(err <= 1e-4 * scale, f"ssd_chunked differs from the recurrence "
          f"by {err}")
    print(f"wide ssd_chunked at mamba2's heads (H={H}, P={P}, N={N}, G={G}), "
          f"L={SSD_L} in 2 chunks: y and the final state against the step "
          f"recurrence (float64) within {err:.3e} (values up to "
          f"{scale:.3f}; tolerance 1e-4) [{card}]")
    del x, a, Bm, Cm, y, final, ref_y, ref_h
    free(torch)

    cfg = dataclasses.replace(get_config("qwen3-moe-235b-a22b"), num_layers=1,
                              stages=(((ATTN,), 1),))
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    _numel_check(torch, f"wide {cfg.name} (1 of 94 layers)", params,
                 WIDE_NUMEL[cfg.name], card)
    gen = torch.Generator(device=dev).manual_seed(2)
    toks = torch.randint(0, cfg.vocab_size, (2, 17), generator=gen,
                         device=dev, dtype=torch.int32)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}

    def grads():
        xs = [x.detach().requires_grad_(True) for x in leaves(params)]
        loss = model.loss_fn(_rebuild(params, iter(xs)), batch)
        return loss.detach(), torch.autograd.grad(loss, xs)
    torch.cuda.reset_peak_memory_stats(dev)
    loss1, g1 = grads()
    check(bool(torch.isfinite(loss1)) and all(
        bool(torch.isfinite(x).all()) for x in g1),
        f"{cfg.name}: non-finite loss or gradient")
    loss2, g2 = grads()
    same = bool(torch.equal(loss1, loss2)) and all(
        torch.equal(a, b) for a, b in zip(g1, g2))
    check(same, f"{cfg.name}: two gradients of one batch differ")
    print(f"wide {cfg.name}: loss {float(loss1):.4f} (ln vocab "
          f"{math.log(cfg.vocab_size):.4f}) and its gradient at B=2, L=16 "
          f"finite; two gradients bit-identical: True; peak "
          f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB allocated "
          f"[{card}]")
    del g1, g2
    free(torch)
    wide = dataclasses.replace(cfg, capacity_factor=MOE_DECODE_CAPACITY)
    print(f"wide {cfg.name}: capacity_factor {cfg.capacity_factor} -> "
          f"{MOE_DECODE_CAPACITY} for the decode comparison only")
    lm_decode_check(torch, params, wide, dev, card, prefill=False, P=8,
                    label=f"wide {cfg.name}")
    del params, model
    free(torch)

    cfg = get_config("seamless-m4t-medium")
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    _numel_check(torch, f"wide {cfg.name} ({cfg.num_layers} + "
                 f"{cfg.num_encoder_layers} layers)", params,
                 WIDE_NUMEL[cfg.name], card)
    B, L = 2, 64
    gen = torch.Generator(device=dev).manual_seed(3)
    toks = torch.randint(0, cfg.vocab_size, (B, L + 1), generator=gen,
                         device=dev, dtype=torch.int32)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:],
             "audio_embeds": torch.randn(
                 (B, L // cfg.encoder_frames_ratio, cfg.d_model),
                 generator=gen, device=dev) * 0.1}
    with torch.no_grad():
        logits, _ = model.forward(params, batch)
        loss = model.loss_fn(params, batch)
        cache = model.init_cache(B, L, device=dev)
        steps = []
        for t in range(3):
            lg, cache = model.decode_step(params, cache, toks[:, t], t)
            steps.append(lg)
    check(tuple(logits.shape) == (B, L, cfg.vocab_size)
          and bool(torch.isfinite(logits).all())
          and bool(torch.isfinite(loss)), f"{cfg.name}: forward")
    check(all(bool(torch.isfinite(x).all()) for x in steps),
          f"{cfg.name}: decode")
    print(f"wide {cfg.name}: forward on {L // cfg.encoder_frames_ratio} "
          f"source frames and {L} tokens finite, loss {float(loss):.4f} "
          f"(ln vocab {math.log(cfg.vocab_size):.4f}); 3 decode steps finite "
          f"(decode reads the zero cross cache, ROADMAP C13) [{card}]")
    del params, model, logits, cache, steps
    free(torch)
    print(f"wide models took {time.perf_counter() - t0:.1f} s")


# --- phase 4h: the train stack ------------------------------------------------

# (a) the serving driver at its defaults: gemma2-2b (arXiv:2408.00118) at its
# published size, all 26 layers, batch 4, a prompt of 64, 32 generated
SERVE_NUMEL = 2614222080            # = param_count(): the embedding tied
SERVE_SHAPE = (4, 64, 32)               # batch, prompt, generated
SERVE_TRACED = 8                        # decode steps traced
# (b) the AFL train step at yi-9b's widths, one layer (phase 4f's cut), on
# batches of the LM task's token stream, each rule through the kernels and
# again through their plain versions
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 8, 8, 256
TRAIN_RULES = ("ace", "aced")
EXAMPLE_STEPS = 100                    # examples/torch_train_lm.py's run
# (c) the train driver at tests/test_system.py's reduced sizes; ACE with an
# int8 cache, checkpoints every 60 events (at 64 and 119 with chunks of 64)
DRIVER_ARGS = ["--arch", "gemma2-2b", "--reduced", "--d-model", "128",
               "--layers", "2", "--vocab", "256", "--seq", "64", "--batch",
               "8", "--steps", "120", "--algo", "ace", "--n-clients", "4",
               "--lr-scale", "1.0", "--log-every", "60", "--ckpt-every", "60"]


def _quiet(fn):
    """`fn()` with its standard output kept -> (its result, the output)."""
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn()
    return out, buf.getvalue()


def serve_phase(torch, dev, card):
    """(a) `repro_torch.launch.serve.main([])` twice (gemma2-2b at its
    published size): (4, 32) tokens in [0, vocab), the same both times;
    `generate` on the same model, weights and prompts timed (prefill and
    generation, prefill alone twice) and equal to main's tokens; 32 decode
    steps after the prompt timed alone, twice; the last
    prompt step's logits against the forward pass over the prompt within
    3e-3 (phase 4f's gate); decode FLOP/s from `analytic.decode_flops`;
    `SERVE_TRACED` decode steps traced (device kernels and busy ms a step,
    the idle share, the largest kernels); then
    examples/torch_serve_batch.py."""
    from repro_torch.configs.registry import get_config
    from repro_torch.convert import leaves
    from repro_torch.launch import analytic, serve
    from repro_torch.models import build_model

    B, P, G = SERVE_SHAPE
    cfg = get_config("gemma2-2b")
    walls, gens = [], []
    for _ in range(2):
        t0 = time.perf_counter()
        gen, out = _quiet(lambda: serve.main([]))
        walls.append(time.perf_counter() - t0)
        gens.append(gen)
        free(torch)
    print(out.strip().replace("\n", "; ") + f" [{card}]")
    check(gens[0].shape == (B, G), f"serve: tokens of shape {gens[0].shape}")
    check(bool(((gens[0] >= 0) & (gens[0] < cfg.vocab_size)).all()),
          "serve: a token out of range")
    check((gens[0] == gens[1]).all(), "serve: two runs with one seed differ")

    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    numel = sum(x.numel() for x in leaves(params))
    check(numel == SERVE_NUMEL, f"serve: {numel} numbers, expected "
          f"{SERVE_NUMEL}")
    prompts = serve.make_prompts(cfg.vocab_size, B, P, 0, dev)

    def timed(n_gen):
        g = torch.Generator(device=dev).manual_seed(0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = serve.generate(model, params, prompts, n_gen, 0.8, g)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0
    timed(0)                                  # warm-up
    (_, last), t_p1 = timed(0)
    (tokens, last2), t_all = timed(G)
    _, t_p2 = timed(0)
    check(bool(torch.isfinite(last).all()), "serve: non-finite logits")
    check(torch.equal(last, last2), "serve: prefill logits differ between "
          "two calls")
    check((tokens.cpu().numpy() == gens[0]).all(),
          "serve: generate differs from main's tokens")
    with torch.no_grad():
        logits, _ = model.forward(params, {"tokens": prompts})
    scale = max(1.0, float(logits[:, -1].abs().max()))
    err = float((last - logits[:, -1]).abs().max())
    check(err <= 3e-3 * scale, f"serve: the last prompt step's logits differ "
          f"from the forward pass by {err}")
    del logits, last, last2, tokens
    free(torch)

    def decode(n, prof=None):
        """n decode steps after the prompt's (argmax tokens), the host
        clock around them to a sync -> seconds."""
        with torch.no_grad():
            cache = model.init_cache(B, P + n, device=dev)
            for t in range(P):
                lg, cache = model.decode_step(params, cache, prompts[:, t], t)
            tok = torch.argmax(lg, -1).to(torch.int32)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with prof or contextlib.nullcontext():
                for t in range(P, P + n):
                    lg, cache = model.decode_step(params, cache, tok, t)
                    tok = torch.argmax(lg, -1).to(torch.int32)
                torch.cuda.synchronize()
            return time.perf_counter() - t0
    t_d = [decode(G) for _ in range(2)]
    decode_ms = 1e3 * sum(t_d) / 2 / G
    flops = sum(analytic.decode_flops(cfg, B, t + 1) for t in range(P, P + G))
    print(f"serve {cfg.name} at its published size ({cfg.num_layers} layers, "
          f"{numel} numbers, {4 * numel / 1e9:.2f} GB f32), batch {B}, "
          f"prompt {P}, {G} generated: main twice {walls[0]:.2f} / "
          f"{walls[1]:.2f} s, tokens identical; generate {1e3 * t_all:.1f} "
          f"ms for {P + G} steps ({1e3 * t_all / (P + G):.2f} ms a step); "
          f"prefill alone {1e3 * t_p1 / P:.2f} / {1e3 * t_p2 / P:.2f} ms a "
          f"step; {G} decode steps {1e3 * t_d[0] / G:.2f} / "
          f"{1e3 * t_d[1] / G:.2f} ms a step ({1e3 * B / decode_ms:.1f} "
          f"tok/s, {flops / G / (decode_ms / 1e3) / 1e12:.3f} TFLOP/s by "
          f"analytic.decode_flops); last prompt logits against the forward "
          f"pass: max |diff| {err:.3e} (logits up to {scale:.3f}; tolerance "
          f"3e-3) [{card}]")
    # where a decode step's time goes: SERVE_TRACED steps after the prompt
    prof = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])
    decode(SERVE_TRACED, prof)
    events = device_kernels(torch, prof)
    busy = sum(e.self_device_time_total for e in events) / 1e3 / SERVE_TRACED
    kernels = sum(e.count for e in events) / SERVE_TRACED
    gemv = sum(e.self_device_time_total for e in events
               if re.search(r"gemv|gemm", e.key, re.I)) / 1e3 / SERVE_TRACED
    weights_ms = 1e3 * 4 * numel / HBM_BYTES_PER_S
    print(f"serve decode traced ({SERVE_TRACED} steps): {kernels:.1f} device "
          f"kernels a step, device busy {busy:.4f} ms a step of "
          f"{decode_ms:.2f} ms wall (idle share {1 - busy / decode_ms:.3f}); "
          f"matrix-vector products {gemv:.4f} ms a step (the f32 weights' "
          f"stream alone takes {weights_ms:.3f} ms at 3.35 TB/s) [{card}]")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:5]:
        print(f"  {e.self_device_time_total / 1e3 / SERVE_TRACED:.4f} ms/step "
              f"{e.count / SERVE_TRACED:.1f} launches/step  {e.key[:90]}")
    del model, params
    free(torch)
    t0 = time.perf_counter()
    out, _ = _quiet(example_main("torch_serve_batch"))
    check(sorted(out) == ["gemma2-2b", "mamba2-780m", "minicpm3-4b"] and all(
        g.shape == (2, 16) for g in out.values()), "torch_serve_batch")
    print(f"examples/torch_serve_batch.py: {len(out)} reduced archs served "
          f"in {time.perf_counter() - t0:.1f} s [{card}]")


def train_step_phase(torch, ops, dev, card, totals):
    """(b) `make_afl_train_step(model.loss_fn, afl_config("yi-9b",
    algorithm=a, n_clients=8), sgd(0.1))` for ACE and ACED (int8 tree
    caches) at yi-9b's widths, one layer: `TRAIN_STEPS` steps of batch 8 ×
    seq 256 from the LM task's token stream, clients in turn, staleness
    from the port's stream; both quant kernels launched, the parameters
    finite, and the same steps through the plain versions (``backend=
    "torch"``) within 1e-4 (relative) at the end; ms a step, peak memory
    and FLOP/s against 3 × `analytic.forward_flops`."""
    import math
    import numpy as np
    from repro_torch.configs.registry import afl_config
    from repro_torch.convert import leaves
    from repro_torch.core import make_lm_task
    from repro_torch.core.distributed import (afl_state_bytes,
                                              make_afl_train_step)
    from repro_torch.core.scan_staleness import build_staleness_randomness
    from repro_torch.core.staleness_sim import default_tau_max
    from repro_torch.data.synthetic import make_token_stream
    from repro_torch.launch import analytic
    from repro_torch.models import build_model
    from repro_torch.optim import sgd

    cfg = lm_config("4f")
    task = make_lm_task(cfg=cfg, device=dev, **LM_TASK)
    params = task.params0
    numel = sum(x.numel() for x in leaves(params))
    check(numel == LM_CUTS["4f"][2], f"train step: {numel} numbers")
    model = build_model(cfg)
    n, S, L = LM_TASK["n_clients"], TRAIN_STEPS, TRAIN_SEQ
    toks = make_token_stream(n_tokens=LM_TASK["n_tokens"],
                             vocab=cfg.vocab_size, seed=LM_TASK["seed"])
    per = len(toks) // n
    rng = np.random.default_rng(0)
    windows = []
    for s in range(S):
        lo = (s % n) * per + rng.integers(0, per - L - 1, size=TRAIN_BATCH)
        windows.append(np.stack([toks[a:a + L + 1] for a in lo]))
    windows = torch.as_tensor(np.stack(windows)).to(dev)
    rand = build_staleness_randomness(0, S, n, 5.0, device=dev)
    tau = torch.clamp(torch.floor(rand.tau_raw), max=default_tau_max(5.0)
                      ).to(torch.int32)
    flops = 3 * analytic.forward_flops(cfg, TRAIN_BATCH, L)

    def run(aflc, backend):
        init_fn, step_fn = make_afl_train_step(model.loss_fn, aflc, sgd(0.1),
                                               backend=backend)
        state = init_fn(params)
        torch.cuda.synchronize()
        stamps, losses = [time.perf_counter()], []
        for s in range(S):
            batch = {"tokens": windows[s, :, :-1],
                     "targets": windows[s, :, 1:]}
            state, m = step_fn(state, batch, s % n, tau[s])
            losses.append(m["loss"])
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())
        new = [x.cpu() for x in leaves(state.params)]
        check(all(bool(torch.isfinite(x).all()) for x in new),
              f"train step {aflc.algorithm}: non-finite parameters")
        check(all(math.isfinite(float(x)) for x in losses),
              f"train step {aflc.algorithm}: non-finite loss")
        del state
        return new, np.diff(stamps), [float(x) for x in losses]

    for algo in TRAIN_RULES:
        aflc = afl_config("yi-9b", algorithm=algo, n_clients=n)
        check(aflc.cache_dtype == "int8", "train step: yi-9b's cache is int8")
        free(torch)
        torch.cuda.reset_peak_memory_stats(dev)
        (kern, secs, losses), counts = counted(
            ops, totals, lambda: run(aflc, None))
        peak = (torch.cuda.max_memory_allocated(dev) / 1e9,
                torch.cuda.max_memory_reserved(dev) / 1e9)
        for kernel in TREE_KERNELS:
            check(counts[kernel] > 0, f"train step {algo}: {kernel} not "
                  "launched")
        free(torch)
        ops.reset_launch_counts()
        plain, psecs, _ = run(aflc, "torch")
        check(sum(ops.launch_counts().values()) == 0,
              f"train step {algo}: backend='torch' launched a kernel")
        top = max(float(x.abs().max()) for x in kern)
        dev_w = max(float((a - b).abs().max())
                    for a, b in zip(plain, kern)) / max(top, 1e-12)
        check(dev_w <= 1e-4, f"train step {algo}: the plain versions end "
              f"{dev_w} (relative) from the kernels")
        same = all(torch.equal(a, b) for a, b in zip(plain, kern))
        ms = 1e3 * float(np.mean(secs[1:]))
        print(f"train step {algo} int8 at yi-9b's widths (1 layer, {numel} "
              f"numbers, n={n}, batch {TRAIN_BATCH} x seq {L}): {S} steps, "
              f"first {1e3 * secs[0]:.1f} ms, then {ms:.1f} ms a step "
              f"(plain versions {1e3 * float(np.mean(psecs[1:])):.1f}); "
              f"{flops / (ms / 1e3) / 1e12:.2f} TFLOP/s against 3 x "
              f"analytic.forward_flops = {flops / 1e12:.3f} TFLOP a step; "
              f"loss {losses[0]:.4f} -> {losses[-1]:.4f}; peak {peak[0]:.2f} "
              f"GB allocated, {peak[1]:.2f} GB reserved (afl_state_bytes "
              f"{afl_state_bytes(aflc, params, 'tree') / 1e9:.2f} GB); "
              f"launches {counts}; plain versions within {dev_w:.3e} "
              f"(relative), bit-identical: {same} [{card}]")
        del kern, plain
    del task, params, model, windows
    free(torch)


def _same_checkpoints(a, b):
    """Two checkpoint files' arrays bit for bit -> the number of leaves."""
    import numpy as np
    with np.load(a) as x, np.load(b) as y:
        check(sorted(x.files) == sorted(y.files), f"{a}, {b}: other leaves")
        for k in x.files:
            check(x[k].dtype == y[k].dtype and np.array_equal(
                x[k].reshape(-1).view(np.uint8),
                y[k].reshape(-1).view(np.uint8)), f"{a}, {b}: {k} differs")
        return len(x.files)


def driver_phase(torch, ops, dev, card, totals):
    """(c) `repro_torch.launch.train.main` at tests/test_system.py's reduced
    sizes (`DRIVER_ARGS`) with an int8 cache, checkpoints in a temporary
    directory the phase removes: the final loss below 5.75 (JAX's bound);
    the straight run's directory with only its checkpoint before the last
    resumed (the final checkpoint bit for bit the straight run's), and
    with its newest checkpoint truncated to half (a warning, the one
    before restored, the same final checkpoint); ``--driver host`` against
    the engine with f32 caches within 1e-5; a faulted run with the clip
    and resync (its guard counters); examples/torch_train_lm.py runs its
    300 steps."""
    import math
    import os
    import shutil
    import tempfile
    import warnings
    from repro_torch.launch.train import main as train_main

    def drive(args, label):
        t0 = time.perf_counter()
        (final, out), counts = counted(ops, totals, lambda: _quiet(
            lambda: train_main(args)))
        wall = time.perf_counter() - t0
        check(math.isfinite(final), f"driver {label}: final loss {final}")
        return final, out, counts, wall

    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        d1, d2, d3 = (os.path.join(tmp, x) for x in ("a", "b", "c"))
        int8 = DRIVER_ARGS + ["--cache-dtype", "int8"]
        final, out, counts, wall = drive(int8 + ["--ckpt-dir", d1], "int8")
        check(final < 5.75, f"driver: final loss {final}, not below 5.75")
        for kernel in TREE_KERNELS:
            check(counts[kernel] > 0, f"driver: {kernel} not launched")
        names = sorted(f for f in os.listdir(d1) if f.endswith(".npz"))
        check(names == ["afl_00000064.npz", "afl_00000119.npz"],
              f"driver: checkpoints {names}")
        print(f"driver {' '.join(int8)}: final loss "
              f"{final:.4f} (bound 5.75) in {wall:.1f} s, checkpoints "
              f"{names}; launches {counts} [{card}]")
        last = names[-1]
        shutil.copytree(d1, d2)
        for suffix in ("", ".sha256"):
            os.remove(os.path.join(d2, last + suffix))
        _, out, _, wall = drive(int8 + ["--ckpt-dir", d2], "resumed")
        check("resumed from event 64" in out, "driver: no resume from 64")
        leaves_n = _same_checkpoints(os.path.join(d1, last),
                                     os.path.join(d2, last))
        print(f"driver resumed from event 64 ({wall:.1f} s): the final "
              f"checkpoint's {leaves_n} leaves bit for bit the straight "
              f"run's [{card}]")
        shutil.copytree(d1, d3)
        with open(os.path.join(d3, last), "r+b") as f:
            f.truncate(f.seek(0, 2) // 2)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            _, out, _, wall = drive(int8 + ["--ckpt-dir", d3], "truncated")
        check(any(issubclass(w.category, RuntimeWarning)
                  and "corrupt" in str(w.message) for w in caught),
              "driver: no warning for the truncated checkpoint")
        check("resumed from event 64" in out, "driver: no fallback to 64")
        _same_checkpoints(os.path.join(d1, last), os.path.join(d3, last))
        print(f"driver with its newest checkpoint truncated to half: warned, "
              f"resumed from event 64 ({wall:.1f} s), final checkpoint bit "
              f"for bit the straight run's [{card}]")
    finally:
        shutil.rmtree(tmp)

    f32 = DRIVER_ARGS + ["--cache-dtype", "float32"]
    scan, _, _, wall_s = drive(f32, "scan f32")
    host, _, _, wall_h = drive(f32 + ["--driver", "host"], "host f32")
    check(abs(scan - host) <= 1e-5, f"driver: host {host} against scan "
          f"{scan}")
    print(f"driver f32 caches: scan {scan:.6f} ({wall_s:.1f} s), host "
          f"{host:.6f} ({wall_h:.1f} s), |diff| {abs(scan - host):.3e} "
          f"(tolerance 1e-5) [{card}]")
    faulted = int8 + ["--fault-nan-rate", "0.05", "--clip-norm", "1.0",
                      "--resync-every", "10"]
    final, out, counts, wall = drive(faulted, "faulted")
    line = next((s for s in out.splitlines()
                 if s.startswith("guard counters")), "")
    check(line and "'quarantined': 0," not in line,
          f"driver faulted: guard counters {line!r}")
    print(f"driver faulted (--fault-nan-rate 0.05 --clip-norm 1.0 "
          f"--resync-every 10): {line}; final loss {final:.4f} ({wall:.1f} "
          f"s) [{card}]")
    # the example exits 0 when its final loss is below 5.5 and 1 otherwise,
    # as its JAX twin does; neither package reaches 5.5 in its 300 steps
    # (ROADMAP §C, C15), so the gate is the run itself: every step, a
    # finite loss, the exit code that loss gives, no traceback (at
    # `EXAMPLE_STEPS` steps: 300 until the placed runs took the time)
    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=str(SRC))
    proc = subprocess.run([sys.executable, str(ROOT / "examples" /
                                                "torch_train_lm.py"),
                           "--steps", str(EXAMPLE_STEPS)],
                          capture_output=True, text=True, env=env, cwd=ROOT)
    lines = [s for s in proc.stdout.splitlines()
             if s.startswith("final loss")]
    ok = (proc.returncode in (0, 1)
          and f"t={EXAMPLE_STEPS:5d}/{EXAMPLE_STEPS}" in proc.stdout
          and len(lines) == 1 and "Traceback" not in proc.stderr)
    final = float(lines[0].split(":")[1].split()[0]) if ok else math.nan
    check(ok and math.isfinite(final) and (final < 5.5) ==
          (proc.returncode == 0), f"examples/torch_train_lm.py exited "
          f"{proc.returncode}: {proc.stdout[-400:]} {proc.stderr[-400:]}")
    print(f"examples/torch_train_lm.py: {EXAMPLE_STEPS} steps in "
          f"{time.perf_counter() - t0:.1f} s, {lines[0]}; exit "
          f"{proc.returncode} (its bound is 5.5; JAX's examples/train_lm.py "
          f"ends at 6.2417 on a CPU and exits 1 too, ROADMAP §C, C15) "
          f"[{card}]")


# --- phase 4i: the sharded runner ---------------------------------------------

# (rule, cache dtype, K, the kernel whose path it takes) at phase 4's widths;
# ACED's K = 1 tick also dequantizes its expired row, the int8 inits quantize
SHARDED_RUNS = (("ace", "int8", 1, "cache_row_update"),
                ("aced", "int8", 1, "row_delta"),
                ("ca2fl", "int8", K_SLICE, "commit_batch"),
                ("aced_direct", "int8", 1, "masked_agg"),
                ("ace", "float32", 1, None))
# the runs traced (a trace of 300 ticks takes ~8 s of the budget)
SHARDED_TRACED = (("ace", "int8", 1), ("ca2fl", "int8", K_SLICE))
SHARDED_BUDGET_S = 60.0


def sharded_phase(torch, ops, task, dev, card, totals, flat_w):
    """The sharded runner (`make_sharded_staleness_runner`) over an NCCL
    group of one rank, initialised here in-process (a file:// rendezvous in
    a temporary directory), on the (1, 1) mesh of `make_host_mesh`: each
    block holds the whole cache, every block collective (the owners'
    all-reduce over ``data``, the feature all-gather over ``model``) still
    runs on its group and is captured in the tick's CUDA graph. For each of
    `SHARDED_RUNS` at phase 4's widths and streams: the final model within
    1e-5 of phase 4's unsharded graph run (`flat_w`) and of this phase's
    own, max |diff| printed and whether it is bit for bit, the captures
    counted, the kernel launched; graph ms a tick sharded against
    unsharded in turns (unsharded, sharded, sharded, unsharded) and, for
    `SHARDED_TRACED`, one traced sharded graph run (device kernels a tick,
    the NCCL kernels' share). All six kernels must launch under the
    sharded runner; the group is destroyed at the end, and the phase must
    take at most `SHARDED_BUDGET_S`."""
    import os
    import tempfile
    import torch.distributed as dist
    from repro_torch.core import make_sharded_staleness_runner
    from repro_torch.launch import make_host_mesh
    t_start = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_pg_")
    torch.cuda.set_device(torch.cuda.current_device())
    dist.init_process_group("nccl", init_method=f"file://{tmp}/pg", rank=0,
                            world_size=1)
    seen = dict.fromkeys(KERNELS, 0)
    try:
        mesh = make_host_mesh()
        check(tuple(mesh.shape) == (1, 1), f"mesh {tuple(mesh.shape)}")
        print(f"sharded: NCCL group of {dist.get_world_size()} rank, mesh "
              f"{dict(zip(mesh.mesh_dim_names, mesh.shape))} on "
              f"{mesh.device_type}")
        for rule, dtype, K, kernel in SHARDED_RUNS:
            label = f"sharded {rule} {dtype} K={K}"
            T, E = _depth(rule, K)
            args = (*engine_streams(task, K, E, dev), engine_lr(task, T))
            plain = engine_runner(task, rule, dtype, K, T, dev)
            sharded = make_sharded_staleness_runner(
                mesh=mesh, grad_fn=task.grad_fn, params0=task.params0,
                aggregator=make_rule(rule, dtype, K),
                n_clients=task.n_clients, T=T, beta=5.0, k_batch=K,
                device=dev)
            (out, _), counts = counted(
                ops, totals, lambda: run_engine(torch, sharded, *args))
            for k, v in counts.items():
                seen[k] += v
            check(sharded.captures >= 1, f"{label}: no capture")
            if kernel is not None:
                check(counts[kernel] > 0, f"{label}: {kernel} not launched")
            mine, _ = run_engine(torch, plain, *args)
            w = out[0].cpu().numpy()
            diff = float(abs(w - flat_w[rule, dtype, K]).max())
            own = float(abs(w - mine[0].cpu().numpy()).max())
            check(diff <= 1e-5 and own <= 1e-5, f"{label}: final model "
                  f"{diff} from phase 4's, {own} from this phase's "
                  "unsharded run")
            walls = [run_engine(torch, r, *args)[1]
                     for r in (plain, sharded, sharded, plain)]
            ms = [1e3 * x / E for x in walls]
            print(f"{label}: {E} ticks, captures {sharded.captures}, final "
                  f"model max |diff| {diff:.3e} from phase 4's graph run "
                  f"(bit for bit: {diff == 0.0}), {own:.3e} from the "
                  f"unsharded run here; launches {counts}; graph wall ms "
                  f"per tick unsharded {ms[0]:.4f}, sharded {ms[1]:.4f}, "
                  f"sharded {ms[2]:.4f}, unsharded {ms[3]:.4f} [{card}]")
            if (rule, dtype, K) in SHARDED_TRACED:
                # where the sharded tick's time goes, its NCCL kernels. A
                # measurement, not a gate: the launches are the counters'
                # and the model is held against phase 4's above, so traces
                # the profiler lost events from are reported, not fatal
                try:
                    trace_engine(torch, ops, label + " graph", sharded, args,
                                 E, (ms[1] + ms[2]) / 2, card, top=3,
                                 must=(kernel,), groups={"nccl": r"nccl"})
                except SmokeFailure as e:
                    print(f"{label}: no trace: {e} [{card}]")
            del plain, sharded, out, mine
        for name, n in seen.items():
            check(n > 0, f"sharded: {name} was not launched under the "
                  "sharded runner")
    finally:
        dist.destroy_process_group()
        for f in os.listdir(tmp):
            os.remove(os.path.join(tmp, f))
        os.rmdir(tmp)
    took = time.perf_counter() - t_start
    check(took <= SHARDED_BUDGET_S, f"phase 4i took {took:.1f} s")
    print(f"sharded: launches under the sharded runner {seen}")
    return took


# --- phase 4j: the dry run against the card ------------------------------------

# the dry run's peak of the plain-version step against the card's, and the
# phase's budget
DRYRUN_PEAK_TOL, DRYRUN_BUDGET_S = 0.20, 30.0


def dryrun_phase(torch, ops, dev, card, totals):
    """The dry run (`repro_torch.launch.dryrun`) against the card at 4h
    (b)'s cut: yi-9b's widths, one layer, n = 8 clients, int8 tree caches,
    one train step of batch 8 × seq 256 (remat none, sgd(0.1)), ACE and
    ACED. For each rule: (a) the dry run's FLOPs (FlopCounterMode over fake
    CUDA tensors) equal FlopCounterMode's count of the real step on the
    card, through the plain versions and through the kernels; (b) the dry
    run's peak (MemTracker, the plain versions' step, its arguments
    included) within `DRYRUN_PEAK_TOL` of the plain step's
    ``torch.cuda.max_memory_allocated`` after ``reset_peak_memory_stats``
    (called once the arguments are made), less what was allocated before
    they were made, with nothing else of the script alive; the kernels'
    peak printed beside it. Then
    (c) one production record (yi-9b, train_4k, single pod; without the
    probes, which the CPU runs) printed. At most `DRYRUN_BUDGET_S`."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs.base import InputShape
    from repro_torch.configs.registry import afl_config
    from repro_torch.core.distributed import make_afl_train_step
    from repro_torch.launch import dryrun
    from repro_torch.models import build_model
    from repro_torch.optim import sgd
    t_start = time.perf_counter()
    cfg = lm_config("4f")
    n, B, L = LM_TASK["n_clients"], TRAIN_BATCH, TRAIN_SEQ
    shape = InputShape("4j", L, B, "train")
    model = build_model(cfg)
    for algo in TRAIN_RULES:
        aflc = afl_config("yi-9b", algorithm=algo, n_clients=n)
        check(aflc.cache_dtype == "int8", "dry run: yi-9b's cache is int8")
        t0 = time.perf_counter()
        rec, _, _ = dryrun.trace_train("yi-9b", shape, None, algo=algo,
                                       remat="none", lr=0.1, cfg=cfg,
                                       n_clients=n)
        t_dry = time.perf_counter() - t0
        check(rec["coll_counts"] == 0, f"dry run {algo}: collectives")
        real = {}
        for backend in (None, "torch"):
            free(torch)
            base = torch.cuda.memory_allocated(dev)
            gen = torch.Generator(device=dev).manual_seed(0)
            params = model.init(gen, device=dev)
            init_fn, step_fn = make_afl_train_step(
                model.loss_fn, aflc, sgd(0.1), backend=backend)
            state = init_fn(params)
            del params
            toks = torch.randint(0, cfg.vocab_size, (B, L + 1),
                                 generator=gen, device=dev,
                                 dtype=torch.int64).to(torch.int32)
            batch = {"tokens": toks[:, :-1].contiguous(),
                     "targets": toks[:, 1:].contiguous()}
            del toks
            zero = torch.zeros((), dtype=torch.int32, device=dev)
            # the window opens on the step's arguments, as the dry run's
            # does (the init's transients, e.g. ACE's mean of the cache,
            # are not the step's)
            torch.cuda.reset_peak_memory_stats(dev)
            with FlopCounterMode(display=False) as fc:
                (state, m), counts = counted(
                    ops, totals, lambda: step_fn(state, batch, zero, zero))
            torch.cuda.synchronize(dev)
            check(bool(torch.isfinite(m["loss"])),
                  f"dry run {algo}: the real step's loss is not finite")
            real[backend] = (float(fc.get_total_flops()),
                             torch.cuda.max_memory_allocated(dev) - base,
                             counts)
            del state, m, batch, zero, step_fn, init_fn
        free(torch)
        flops, peak, _ = real["torch"]
        kflops, kpeak, kcounts = real[None]
        check(rec["flops"] == flops == kflops, f"dry run {algo}: FLOPs "
              f"{rec['flops']:.6e} against the card's {flops:.6e} (plain) "
              f"and {kflops:.6e} (kernels)")
        for kernel in TREE_KERNELS:
            check(kcounts[kernel] > 0, f"dry run {algo}: {kernel} not "
                  "launched by the real step")
        rel = (rec["peak_bytes"] - peak) / peak
        print(f"dry run {algo} int8 at yi-9b's widths (1 layer, n={n}, "
              f"batch {B} x seq {L}): traced in {t_dry:.2f} s; FLOPs "
              f"{rec['flops']:.6e} dry, {flops:.6e} the card's plain step, "
              f"{kflops:.6e} its kernel step (equal: "
              f"{rec['flops'] == flops == kflops}); peak "
              f"{rec['peak_bytes'] / 1e9:.3f} GB dry (plain versions) "
              f"against {peak / 1e9:.3f} GB max_memory_allocated of the "
              f"plain step ({100 * rel:+.2f}%), kernel step "
              f"{kpeak / 1e9:.3f} GB; launches {kcounts} [{card}]")
        check(abs(rel) <= DRYRUN_PEAK_TOL, f"dry run {algo}: peak "
              f"{rec['peak_bytes'] / 1e9:.3f} GB against the card's "
              f"{peak / 1e9:.3f} GB ({100 * rel:+.1f}%)")
    del model
    free(torch)
    prod = dryrun.run_one("yi-9b", "train_4k", multi_pod=False,
                          probes=False)
    check("error" not in prod and prod["spec_argument_bytes_per_rank"] > 0,
          f"dry run: the production record {prod}")
    print("dry run production record: " + json.dumps(prod))
    took = time.perf_counter() - t_start
    check(took <= DRYRUN_BUDGET_S, f"phase 4j took {took:.1f} s")
    return took


# --- phase 4k: the model laid out by the specs ---------------------------------

# the train steps a rule; decode: batch, cache length, steps; the clients of
# (c)'s run, whose state is checkpointed (at 8 its 4.6 GB file took 26.5 s
# to write, sync and read back, PR 29 call 1; at 2, 2.9 GB); the phase's
# budget (PR 28's 40 s, and 25 s for runs (c)-(e))
PLACED_STEPS = 3
PLACED_DECODE = (4, 64, 8)
PLACED_CKPT_CLIENTS = 2
PLACED_BUDGET_S = 65.0


def placed_train_turns(torch, ops, totals, model, params, batches, aflc, mesh,
                       label, card, keep=False):
    """`PLACED_STEPS` AFL train steps of `aflc` from one init, in turns
    unplaced, placed, placed, unplaced: parameters and losses bit for bit,
    both quant kernels launched by the placed steps, ms a step each way
    printed. With `keep`, the first placed run's final state is returned
    (for the checkpoint), else None."""
    import numpy as np
    from repro_torch.convert import leaves
    from repro_torch.core.distributed import make_afl_train_step
    from repro_torch.optim import sgd
    from repro_torch.sharding import place
    init_fn, step_fn = make_afl_train_step(model.loss_fn, aflc, sgd(0.1))
    n, kept = aflc.n_clients, []

    def run(placed):
        state, bs = init_fn(params), batches
        if placed:
            state, first = place.place_train(state, batches[0], mesh)
            check(place.tree_mesh(state.params) is not None,
                  f"{label}: the parameters are not placed")
            bs = [first] + [place.place_batch(b, mesh) for b in batches[1:]]
        torch.cuda.synchronize()
        stamps, losses = [time.perf_counter()], []
        for s, b in enumerate(bs):
            state, m = step_fn(state, b, s % n, s)
            losses.append(m["loss"])
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())
        new = [x.cpu() for x in leaves(place.full_tree(state.params))]
        if placed and keep and not kept:
            kept.append(state)
        del state
        return new, np.diff(stamps), [float(x) for x in losses]

    runs = []
    for placed in (False, True, True, False):
        free(torch)
        out, counts = counted(ops, totals, lambda: run(placed))
        if placed:
            for kernel in TREE_KERNELS:
                check(counts[kernel] > 0, f"{label}: {kernel} not launched "
                      "by the placed steps")
        runs.append((placed, out, counts))
    (_, (ref, ref_s, ref_l), _), (_, (got, got_s, got_l), pc) = \
        runs[0], runs[1]
    diff = max(float((a - b).abs().max()) for a, b in zip(got, ref))
    same = (all(torch.equal(a, b) for a, b in zip(got, ref))
            and got_l == ref_l)
    check(same, f"{label}: the placed steps end {diff} from the unplaced "
          f"ones (losses {got_l} against {ref_l})")
    ms = {p: [1e3 * float(np.mean(o[1][1:])) for q, o, _ in runs if q == p]
          for p in (False, True)}
    print(f"{label}, {PLACED_STEPS} steps on the (1, 1) mesh: parameters "
          f"and losses bit for bit with the unplaced steps: {same} (max "
          f"|diff| {diff:.3e}); ms a step in turns unplaced "
          f"{ms[False][0]:.1f}, placed {ms[True][0]:.1f}, placed "
          f"{ms[True][1]:.1f}, unplaced {ms[False][1]:.1f} after each run's "
          f"first step ({1e3 * ref_s[0]:.1f} and {1e3 * got_s[0]:.1f} in the "
          f"first two runs); launches of a placed run {pc} [{card}]")
    return kept[0] if kept else None


def placed_checkpoint(torch, state, mesh, label, card):
    """A placed train state saved (`save_checkpoint`: gathered, rank 0
    writes) and restored into a placed template of its layout: every leaf
    bit for bit, DTensors in their placements and plain leaves plain."""
    import os
    import shutil
    import tempfile
    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.convert import leaves
    from repro_torch.sharding import place
    from repro_torch.sharding.rules import is_placed
    d = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        t0 = time.perf_counter()
        path = save_checkpoint(d, 1, state)
        size = os.path.getsize(path)
        t1 = time.perf_counter()
        back = restore_checkpoint(d, 1, state)
        t2 = time.perf_counter()
        pairs = list(zip(leaves(back), leaves(state)))
        layout = all(is_placed(a) == is_placed(b) and (
            not is_placed(a) or place.same_layout(a, b)) for a, b in pairs)
        same = layout and all(torch.equal(
            a.full_tensor() if is_placed(a) else a,
            b.full_tensor() if is_placed(b) else b) for a, b in pairs)
        del back, pairs
    finally:
        shutil.rmtree(d, ignore_errors=True)
    check(same, f"{label}: the restored placed state differs")
    print(f"{label}: saved ({size / 1e9:.3f} GB, {t1 - t0:.1f} s) and "
          f"restored into its placed layout ({t2 - t1:.1f} s): bit for bit "
          f"with placements and plain leaves kept: {same} [{card}]")


def placed_loss(torch, model, params, batch, mesh, label, card, grad=True):
    """The loss (and with `grad` every parameter's gradient) placed by
    `place_prefill` against unplaced: bit for bit."""
    from repro_torch.convert import _rebuild, leaves
    from repro_torch.sharding import place
    from repro_torch.sharding.rules import is_placed, replicate

    def run(p, b):
        xs = [x.detach().requires_grad_(grad) for x in leaves(p)]
        with place.placed_scope(p), torch.set_grad_enabled(grad):
            loss = replicate(model.loss_fn(_rebuild(p, iter(xs)), b))
            gs = torch.autograd.grad(loss, xs) if grad else ()
        full = [g.full_tensor() if is_placed(g) else g for g in gs]
        loss = loss.full_tensor() if is_placed(loss) else loss
        return loss.detach(), full

    ref_loss, ref_g = run(params, batch)
    pp, pb = place.place_prefill(params, batch, mesh)
    got_loss, got_g = run(pp, pb)
    same = bool(torch.equal(ref_loss, got_loss)) and all(
        torch.equal(a, b) for a, b in zip(got_g, ref_g))
    diff = max([float((a - b).abs().max()) for a, b in zip(got_g, ref_g)]
               + [float((got_loss - ref_loss).abs())])
    del ref_g, got_g, pp, pb
    free(torch)
    what = "loss and gradient" if grad else "loss"
    check(same, f"{label}: the placed {what} differs by {diff}")
    print(f"{label}: the placed {what} bit for bit with the unplaced: "
          f"{same} (loss {float(ref_loss):.4f}, max |diff| {diff:.3e}) "
          f"[{card}]")


def placed_decode(torch, model, params, mesh, first, S, T, label, card,
                  exact=False):
    """`T` decode steps from an empty cache of `S` at `first`'s batch,
    unplaced then placed by `place_decode`: the fed-back argmax tokens equal
    (with `exact`, the logits bit for bit too), the logits' max |diff| and
    ms a step printed."""
    from repro_torch.sharding import place
    dev = first.device

    def decode(placed):
        cache, p, tk = model.init_cache(first.shape[0], S, device=dev), \
            params, first
        if placed:
            p, cache, tk = place.place_decode(params, cache, first, mesh)
        toks, logits_all = [], []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            for pos in range(T):
                logits, cache = model.decode_step(p, cache, tk, pos)
                if placed:
                    logits = logits.full_tensor()
                nxt = logits.argmax(-1).to(torch.int32)
                toks.append(nxt)
                logits_all.append(logits.float())
                tk = place.place_batch(nxt, mesh) if placed else nxt
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        return (torch.stack(toks).cpu(), torch.stack(logits_all).cpu(),
                1e3 * secs / T)

    (ref_t, ref_lg, ref_ms), (got_t, got_lg, got_ms) = (decode(False),
                                                        decode(True))
    lg_diff = float((got_lg - ref_lg).abs().max())
    check(torch.equal(got_t, ref_t), f"{label}: tokens {got_t} against the "
          f"unplaced {ref_t}")
    check(not exact or lg_diff == 0.0, f"{label}: logits differ by "
          f"{lg_diff}")
    print(f"{label} (batch {first.shape[0]}, cache {S}, {T} steps from an "
          f"empty cache) on the (1, 1) mesh: argmax tokens equal to the "
          f"unplaced steps': True; logits max |diff| {lg_diff:.3e} (bit for "
          f"bit: {lg_diff == 0.0}); ms a step unplaced {ref_ms:.1f}, placed "
          f"{got_ms:.1f} [{card}]")


def _first_tokens(torch, cfg, B, dev, seed=1):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randint(0, cfg.vocab_size, (B,), device=dev, generator=g,
                         dtype=torch.int64).to(torch.int32)


def placed_phase(torch, ops, dev, card, totals):
    """The model, the AFL train step and decode laid out by JAX's specs
    (`place_train`, `place_prefill`, `place_decode`: DTensors over
    `make_host_mesh()`'s (1, 1) mesh of an NCCL group of one rank,
    initialised here as 4i's is). At one rank every placement is whole, so
    the placed path must give the unplaced numbers bit for bit while it
    runs every DTensor op, the local-shard code (attention, the MoE, the
    SSD), the kernels on the local shards and the collectives on their
    groups. (a) ACE and ACED with int8 tree caches at 4h (b)'s cut
    (`placed_train_turns`); (b) gemma2-2b at its published size,
    `PLACED_DECODE` decode steps (`placed_decode`); (c) zamba2-1.2b at
    4g's cut: ACE int8 train steps as (a) over `PLACED_CKPT_CLIENTS`
    clients, the placed state saved and restored (`placed_checkpoint`), and
    `PLACED_DECODE` decode steps; (d)
    qwen3-moe-235b-a22b at one layer: loss and gradient at B = 2, L = 16
    (`placed_loss`), then `PLACED_DECODE` decode steps at capacity factor
    `MOE_DECODE_CAPACITY`; (e) seamless-m4t-medium at full depth: the loss
    and three decode steps, bit for bit. Memory is freed between runs and
    each run's seconds printed. At most `PLACED_BUDGET_S`; the group is
    destroyed at the end."""
    import dataclasses
    import os
    import tempfile
    import torch.distributed as dist
    from repro_torch.configs.base import ATTN
    from repro_torch.configs.registry import afl_config, get_config
    from repro_torch.launch import make_host_mesh
    from repro_torch.models import build_model
    t_start = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_pg_")
    dist.init_process_group("nccl", init_method=f"file://{tmp}/pg", rank=0,
                            world_size=1)
    Bd, S, T = PLACED_DECODE
    try:
        mesh = make_host_mesh()
        check(tuple(mesh.shape) == (1, 1), f"mesh {tuple(mesh.shape)}")

        def batches_of(cfg, B, L, gen):
            toks = torch.randint(0, cfg.vocab_size, (PLACED_STEPS, B, L + 1),
                                 generator=gen, device=dev,
                                 dtype=torch.int64).to(torch.int32)
            return [{"tokens": t[:, :-1].contiguous(),
                     "targets": t[:, 1:].contiguous()} for t in toks]

        # (a) yi-9b's widths at one layer, ACE and ACED int8
        t0 = time.perf_counter()
        cfg = lm_config("4f")
        model = build_model(cfg)
        n, B, L = LM_TASK["n_clients"], TRAIN_BATCH, TRAIN_SEQ
        gen = torch.Generator(device=dev).manual_seed(0)
        params = model.init(gen, device=dev)
        batches = batches_of(cfg, B, L, gen)
        for algo in TRAIN_RULES:
            aflc = afl_config("yi-9b", algorithm=algo, n_clients=n)
            check(aflc.cache_dtype == "int8", "placed: yi-9b's cache is "
                  "int8")
            placed_train_turns(
                torch, ops, totals, model, params, batches, aflc, mesh,
                f"placed train step {algo} int8 at yi-9b's widths (1 layer, "
                f"n={n}, batch {B} x seq {L})", card)
        del params, batches, model
        free(torch)
        print(f"placed (a) took {time.perf_counter() - t0:.1f} s")

        # (b) gemma2-2b at its published size, decode
        t0 = time.perf_counter()
        cfg = get_config("gemma2-2b")
        model = build_model(cfg)
        params = model.init(torch.Generator(device=dev).manual_seed(0))
        placed_decode(torch, model, params, mesh,
                      _first_tokens(torch, cfg, Bd, dev), S, T,
                      "placed decode gemma2-2b at its published size", card)
        del params, model
        free(torch)
        print(f"placed (b) took {time.perf_counter() - t0:.1f} s")

        # (c) zamba2-1.2b at 4g's cut: train, decode, checkpoint
        t0 = time.perf_counter()
        cfg = lm_config("4g")
        model = build_model(cfg)
        gen = torch.Generator(device=dev).manual_seed(0)
        params = model.init(gen, device=dev)
        batches = batches_of(cfg, B, L, gen)
        aflc = afl_config("zamba2-1.2b", algorithm="ace",
                          n_clients=PLACED_CKPT_CLIENTS, cache_dtype="int8")
        state = placed_train_turns(
            torch, ops, totals, model, params, batches, aflc, mesh,
            f"placed train step ace int8 at zamba2-1.2b's widths (4g's cut: "
            f"{cfg.num_layers} layers, n={PLACED_CKPT_CLIENTS}, batch {B} x "
            f"seq {L})", card, keep=True)
        del batches
        placed_checkpoint(torch, state, mesh, "placed checkpoint of "
                          "zamba2-1.2b's ace int8 state", card)
        del state
        free(torch)
        placed_decode(torch, model, params, mesh,
                      _first_tokens(torch, cfg, Bd, dev), S, T,
                      "placed decode zamba2-1.2b at 4g's cut", card)
        del params, model
        free(torch)
        print(f"placed (c) took {time.perf_counter() - t0:.1f} s")

        # (d) qwen3-moe-235b-a22b at one layer: loss and gradient, decode
        t0 = time.perf_counter()
        cfg = dataclasses.replace(get_config("qwen3-moe-235b-a22b"),
                                  num_layers=1, stages=(((ATTN,), 1),))
        model = build_model(cfg)
        params = model.init(torch.Generator(device=dev).manual_seed(0))
        gen = torch.Generator(device=dev).manual_seed(2)
        toks = torch.randint(0, cfg.vocab_size, (2, 17), generator=gen,
                             device=dev, dtype=torch.int32)
        placed_loss(torch, model, params,
                    {"tokens": toks[:, :-1], "targets": toks[:, 1:]}, mesh,
                    f"placed {cfg.name} at one layer (B=2, L=16)", card)
        wide = build_model(dataclasses.replace(
            cfg, capacity_factor=MOE_DECODE_CAPACITY))
        placed_decode(torch, wide, params, mesh,
                      _first_tokens(torch, cfg, Bd, dev), S, T,
                      f"placed decode {cfg.name} at one layer, capacity "
                      f"factor {MOE_DECODE_CAPACITY}", card)
        del params, model, wide
        free(torch)
        print(f"placed (d) took {time.perf_counter() - t0:.1f} s")

        # (e) seamless-m4t-medium at full depth: loss, decode
        t0 = time.perf_counter()
        cfg = get_config("seamless-m4t-medium")
        model = build_model(cfg)
        params = model.init(torch.Generator(device=dev).manual_seed(0))
        B2, L2 = 2, 64
        gen = torch.Generator(device=dev).manual_seed(3)
        toks = torch.randint(0, cfg.vocab_size, (B2, L2 + 1), generator=gen,
                             device=dev, dtype=torch.int32)
        batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:],
                 "audio_embeds": torch.randn(
                     (B2, L2 // cfg.encoder_frames_ratio, cfg.d_model),
                     generator=gen, device=dev) * 0.1}
        placed_loss(torch, model, params, batch, mesh,
                    f"placed {cfg.name} at full depth ({B2} x {L2} tokens, "
                    f"{L2 // cfg.encoder_frames_ratio} source frames)", card,
                    grad=False)
        placed_decode(torch, model, params, mesh, toks[:, 0], L2, 3,
                      f"placed decode {cfg.name} at full depth (the zero "
                      f"cross cache, ROADMAP C13)", card, exact=True)
        del params, model
        free(torch)
        print(f"placed (e) took {time.perf_counter() - t0:.1f} s")
    finally:
        dist.destroy_process_group()
        for f in os.listdir(tmp):
            os.remove(os.path.join(tmp, f))
        os.rmdir(tmp)
    took = time.perf_counter() - t_start
    check(took <= PLACED_BUDGET_S, f"phase 4k took {took:.1f} s")
    return took


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

    start = time.perf_counter()
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
    print(f"phase 3 starts at {time.perf_counter() - start:.1f} s")
    errs, rows = {}, {}
    errs["row_delta"], rows["row_delta"] = compare_swap(torch, ops, D_SLICE,
                                                        dev, card)
    errs["row_delta"] = max(errs["row_delta"],
                            compare_swap(torch, ops, D_LARGE, dev, card)[0])
    errs["cache_row_update"], rows["cache_row_update"] = compare_ace(
        torch, ops, D_SLICE, dev, card)
    errs["cache_row_update"] = max(errs["cache_row_update"], compare_ace(
        torch, ops, D_LARGE, dev, card)[0])
    # the text task's width: both row kernels on their cooperative grid
    errs["row_delta"] = max(errs["row_delta"],
                            compare_swap(torch, ops, D_TEXT, dev, card)[0])
    errs["cache_row_update"] = max(errs["cache_row_update"], compare_ace(
        torch, ops, D_TEXT, dev, card)[0])
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
        # one block's width, a ragged last block (d ≡ 2 mod 4), and K off
        # the K = 16 instantiation
        for K, d in ((K_SLICE, 128), (K_SLICE, 130), (K_SLICE + 1, D_SLICE)):
            for R in (1, 2, 3):
                e, _ = compare_commit(torch, ops, K, d, R, dev, card,
                                      rows=row_type)
                errs["commit_batch"] = max(errs["commit_batch"], e)
    errs["masked_agg"], rows["masked_agg"] = compare_masked_agg(
        torch, ops, N_SLICE, D_SLICE, dev, card)
    e_big, _ = compare_masked_agg(torch, ops, N_SLICE, D_ROWS_LARGE, dev,
                                  card)
    errs["masked_agg"] = max(errs["masked_agg"], e_big)
    # the per-tick shape (one arriving row) is the main path's; the
    # (100, d) shapes are the int8 init and the cache-wide dequantizer
    errs["quantize_rows"], rows["quantize_rows"] = compare_quant(
        torch, ops, 1, D_SLICE, dev, card)
    for n, d in ((1, D_TEXT), (N_SLICE, D_SLICE), (N_SLICE, D_ROWS_LARGE),
                 *((1, d) for d in D_QUANT_GRID)):
        compare_quant(torch, ops, n, d, dev, card)
    quant_symbols(torch, ops, dev, card)
    errs["dequantize_rows"], rows["dequantize_rows"] = compare_dequant(
        torch, ops, N_SLICE, D_SLICE, dev, card)
    compare_dequant(torch, ops, N_SLICE, D_ROWS_LARGE, dev, card)
    # odd shapes: a ragged row at the engine's width, and rows shorter than
    # a vector
    for n, d in ((1, D_SLICE + 1), (2, 7)):
        compare_quant(torch, ops, n, d, dev, card, timed=False)
        compare_dequant(torch, ops, n, d, dev, card, timed=False)
    print("library yardstick: torch.mul(q, s[:, None]) for dequantize_rows; "
          "none for the other five — no single PyTorch call computes "
          "row_delta, cache_row_update or commit_batch, torch.mv refuses "
          "int8 rows with f32 weights (masked_agg), and no single call "
          "forms quantize_rows' scales (library_ms null)")

    # 4. the main path, at full width
    print(f"phase 4 starts at {time.perf_counter() - start:.1f} s")
    task = make_vision_task(device=dev)
    d = sum(p.numel() for layer in task.params0 for p in layer.values())
    check(d == D_SLICE, f"vision task has d={d}, expected {D_SLICE}")
    print(f"engine: vision task, n={task.n_clients} clients, d={d}, "
          f"batch 50 [{card}]")
    totals = dict.fromkeys(KERNELS, 0)
    results, kept, clean = {}, {}, {}
    for rule, dtype, K, T, E, kernels in engine_runs():
        label = f"{rule} {dtype or 'no-cache'} K={K}"
        streams, lr = engine_streams(task, K, E, dev), engine_lr(task, T)
        runner = engine_runner(task, rule, dtype, K, T, dev)
        ops.reset_launch_counts()
        out, wall = run_engine(torch, runner, *streams, lr)
        counts = ops.launch_counts()
        for k, v in counts.items():
            totals[k] += v
        check(runner.captures == 1, f"{label}: {runner.captures} captures")
        for kernel in kernels:
            check(counts[kernel] > 0, f"{label}: {kernel} was not launched")
        w = out[0]
        check(bool(torch.isfinite(w).all()), f"{label}: non-finite model")
        acc = task.eval_fn(unravel(w, task.params0))["accuracy"]
        check(acc > 0.5, f"{label}: accuracy {acc}, not well above chance "
              "(0.1)")
        eager = engine_runner(task, rule, dtype, K, T, dev, graph=False)
        ref, wall_e = run_engine(torch, eager, *streams, lr)
        check(same_run(torch, out, ref), f"{label}: the graph run differs "
              "from the eager run")
        updates = int(out[2]["emit"].sum())
        print(f"engine {label}: T={T}, {E} ticks, {updates} updates, "
              f"accuracy {acc:.4f}; graph run {wall:.2f} s with its capture "
              f"({E * K / wall:.1f} arrivals/s), eager run {wall_e:.2f} s "
              f"({E * K / wall_e:.1f} arrivals/s); graph and eager model, "
              f"cache rows and scales and outputs bit-identical: True; "
              f"launches {counts} [{card}]")
        results[rule, dtype, K] = w.cpu().numpy()
        if (rule, dtype, K) in CLEAN_GUARDED:
            clean[rule, dtype, K] = out
        if (rule, dtype, K) in TRACED:
            kept[rule, dtype, K] = (runner, eager, (*streams, lr), E, K)
    for rule, dtype, K in (("ace", "int8", K_SLICE),
                           ("aced_direct", "int8", 1)):
        T, E = _depth(rule, K)
        plain = engine_runner(task, rule, dtype, K, T, dev, backend="torch",
                              graph=False)
        ops.reset_launch_counts()
        out, wall = run_engine(torch, plain, *engine_streams(task, K, E, dev),
                               engine_lr(task, T))
        check(sum(ops.launch_counts().values()) == 0,
              "backend='torch' launched a kernel")
        res_w, ref_w = out[0].cpu().numpy(), results[rule, dtype, K]
        dev_w = float(abs(res_w - ref_w).max() / max(1e-12, abs(ref_w).max()))
        check(dev_w <= 1e-4, f"{rule} {dtype} K={K}: plain run deviates "
              f"{dev_w}")
        print(f"engine {rule} {dtype} K={K} plain versions (eager): "
              f"{wall:.2f} s, {E * K / wall:.1f} arrivals/s, final w within "
              f"{dev_w:.3e} (relative) of the kernels' run, bit-identical: "
              f"{bool((res_w == ref_w).all())} [{card}]")
    for inc in ("ace", "aced", "ca2fl"):
        for dtype in ("int8", "float32"):
            a = results[inc, dtype, 1]
            b = results[inc + "_direct", dtype, 1]
            print(f"engine {inc} vs {inc}_direct, {dtype} K=1, seed 0: final "
                  f"w max |diff| {float(abs(a - b).max()):.3e}, relative "
                  f"{float(abs(a - b).max() / max(1e-12, abs(b).max())):.3e} "
                  f"[{card}]")

    per_tick, flat_ms = time_and_trace(torch, ops, "", kept, card)
    del kept

    # 4b. faults, the guard pipeline, resync and sweeps on the main path
    print(f"phase 4b starts at {time.perf_counter() - start:.1f} s")
    flat_guards = guard_phase(torch, ops, task, dev, card, totals, clean)

    # 4c. the text task, the event engine and the sanitize checks
    print(f"phase 4c starts at {time.perf_counter() - start:.1f} s")
    text_phase(torch, ops, dev, card, totals)
    event_phase(torch, ops, task, dev, card, totals)
    sanitize_phase(torch, ops, task, dev, card, totals,
                   per_tick["aced", "int8", 1])

    # 4d. the host references against the engines, and the quickstart
    start_4d = time.perf_counter()
    print(f"phase 4d starts at {start_4d - start:.1f} s")
    host_phase(torch, ops, task, dev, card, totals)
    print(f"phase 4d took {time.perf_counter() - start_4d:.1f} s")

    # 4e. the tree layout
    start_4e = time.perf_counter()
    print(f"phase 4e starts at {start_4e - start:.1f} s")
    tree_phase(torch, ops, task, dev, card, totals, results, per_tick,
               flat_ms, flat_guards)
    print(f"phase 4e took {time.perf_counter() - start_4e:.1f} s")

    # 4f. the real models: yi-9b's widths at one layer, the LM task
    start_4f = time.perf_counter()
    print(f"phase 4f starts at {start_4f - start:.1f} s")
    lm_phase(torch, ops, dev, card, totals, "4f")
    print(f"phase 4f took {time.perf_counter() - start_4f:.1f} s")

    # 4g. the rest of the real models: zamba2-1.2b's widths at 7 layers on
    # the LM task, then mamba2, the MoE and the encoder-decoder at theirs
    start_4g = time.perf_counter()
    print(f"phase 4g starts at {start_4g - start:.1f} s")
    hybrid, busy_ms = lm_phase(torch, ops, dev, card, totals, "4g")
    del hybrid
    free(torch)
    ssd_share(torch, lm_config("4g"), dev, card, busy_ms)
    wide_phase(torch, dev, card)
    print(f"phase 4g took {time.perf_counter() - start_4g:.1f} s")

    # 4h. the train stack: serving at gemma2-2b's published size, the AFL
    # train step at yi-9b's widths, the train driver with checkpoints
    start_4h = time.perf_counter()
    print(f"phase 4h starts at {start_4h - start:.1f} s")
    before = dict(totals)
    serve_phase(torch, dev, card)
    train_step_phase(torch, ops, dev, card, totals)
    driver_phase(torch, ops, dev, card, totals)
    print(f"phase 4h took {time.perf_counter() - start_4h:.1f} s; its "
          f"launches {({k: totals[k] - before[k] for k in totals})}")

    # 4i. the sharded runner over a one-rank NCCL group
    print(f"phase 4i starts at {time.perf_counter() - start:.1f} s")
    took = sharded_phase(torch, ops, task, dev, card, totals, results)
    print(f"phase 4i took {took:.1f} s")

    # 4j. the dry run over fake tensors against the card's step
    print(f"phase 4j starts at {time.perf_counter() - start:.1f} s")
    took = dryrun_phase(torch, ops, dev, card, totals)
    print(f"phase 4j took {took:.1f} s")

    # 4k. the model, the train step and decode laid out by the specs
    print(f"phase 4k starts at {time.perf_counter() - start:.1f} s")
    took = placed_phase(torch, ops, dev, card, totals)
    print(f"phase 4k took {took:.1f} s")

    # 5. results
    print(f"phase 5 starts at {time.perf_counter() - start:.1f} s")
    report = []
    for name, (source, replaces) in KERNELS.items():
        check(totals[name] > 0, f"{name} never launched on the main path")
        entry = {"name": name, "route": "cuda", "source": source,
                 "replaces": replaces, "launches": totals[name],
                 "max_abs_err": errs[name], **rows[name]}
        if name in ALSO_REPLACES:
            entry["also_replaces"] = ALSO_REPLACES[name]
        report.append(entry)
    print(f"wall time {time.perf_counter() - start:.1f} s")
    print(json.dumps({"kernels": report}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
