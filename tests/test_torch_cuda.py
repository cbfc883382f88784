"""The port's CUDA kernels on the card against their plain PyTorch versions
on the same inputs, and the engine's path through them. Every test here is
`cuda`-marked and skips without a GPU; the module imports no JAX, so it runs
on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

int8 rows and scales must be bit-identical; f32 outputs agree within 1e-6
relative to the output's scale (the kernels build with -fmad=false, so the
remaining differences are the order of the commit kernel's f32 sums;
masked_agg and dequantize_rows sum and multiply in their plain versions'
order and must agree bit for bit, as must the fused row swap
`ops.row_delta` and the whole int8 ACE step `ops.cache_row_update`). A row
holding a NaN or ±inf gets int8 codes 0, as in the JAX package; the tests
pin the zeros as well as comparing with the plain versions. Run only these
with ``-k "masked_agg or row_delta or nan"``, the ACE step's with
``-k "ace or row_kernels"``, the graph runner's (the tick captured as a
CUDA graph, bit-identical to the eager tick; faulted and guarded runs and
one capture serving a sweep included; the event engine and the text task
at its full width too) with ``-k graph``, the sanitize checks with
``-k sanitize``, the host references against the graph runs with
``-k host``, the tree layout (graph = eager for the nine rules on tree
caches, an int8 tree cache through the quant kernels against the CPU)
with ``-k tree``, the real models (the reduced LM task's tree graph run
against its eager run, decode against forward, the quant kernels at
yi-9b's full-width leaf views) with ``-k lm``, the rest of them (the
reduced MoE, Mamba-2, hybrid and encoder-decoder archs against their CPU
runs, MoE gradients bit for bit, the reduced zamba2 LM task's graph run
against eager) with ``-k "ssm or moe"``, the train stack (the AFL train
step on the card against the CPU, checkpoints restored onto CUDA tensors,
the train driver resumed bit for bit) with ``-k train``, the sharded
runner on a one-rank NCCL group (its collectives captured in the tick's
graph) with ``-k sharded``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.convert import unravel  # noqa: E402
from repro_torch.core import aggregators as tagg  # noqa: E402
from repro_torch.core.delays import ExponentialDelays, build_schedule  # noqa: E402
from repro_torch.core.fl_tasks import make_text_task, make_vision_task  # noqa: E402
from repro_torch.core.scan_engine import (default_n_events,  # noqa: E402
                                          make_scan_runner)
from repro_torch.core.simulator import AFLSimulator  # noqa: E402
from repro_torch.core.staleness_sim import StalenessSimulator  # noqa: E402
from repro_torch.core.cache import FlatCache  # noqa: E402
from repro_torch.core.fl_tasks import ClientGrad  # noqa: E402
from repro_torch.core.scan_staleness import (  # noqa: E402
    build_fault_schedule, build_payload_noise, build_staleness_randomness,
    make_chunked_staleness_runner, make_staleness_runner, no_faults,
    run_staleness_grid, run_staleness_scan)
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import cache_update as _cu  # noqa: E402
from repro_torch.kernels import masked_agg as _ma  # noqa: E402
from repro_torch.kernels import quant as _q  # noqa: E402
from repro_torch.kernels import row_delta as _rd  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the H100)")
    return torch.device("cuda")


def _close(a, b, tol=1e-6):
    a, b = a.double().cpu(), b.double().cpu()
    assert float((a - b).abs().max()) <= tol * max(1.0, float(b.abs().max()))


def _same(a, b):
    """Bit for bit, a NaN matching a NaN (their payload bits may differ
    between the kernel and PyTorch's ops)."""
    nan = torch.isnan(a)
    return bool(torch.equal(nan, torch.isnan(b)) and
                torch.equal(torch.where(nan, 0.0, a), torch.where(nan, 0.0, b)))


def row_inputs(seed, d, device):
    g = torch.Generator().manual_seed(seed)
    u = torch.randn(d, generator=g)
    x = torch.randn(d, generator=g) * 5
    # max|g| = 127 makes the new scale 1.0, so these are exact .5 ties
    x[: min(d, 5)] = torch.tensor([127.0, 2.5, -0.5, 1.5, 3.5])[: min(d, 5)]
    q, s = tref.quantize_rows_ref(torch.randn(1, d, generator=g))
    return [t.to(device) for t in (u, x, q[0], s[0], tref.row_scale(x))]


def swap_cache(seed, n, d, device):
    """An int8 cache (data, scale) of n rows."""
    g = torch.Generator().manual_seed(seed)
    q, s = tref.quantize_rows_ref(torch.randn(n, d, generator=g) * 3)
    return q.to(device), s.to(device)


def check_swap(data, scale, j, g, plan=None):
    """The fused row swap on a copy of the cache against its plain version
    on another: every row and scale, delta and old bit for bit."""
    d1, s1 = data.clone(), scale.clone()
    delta1, old1 = (ops.row_delta(d1, s1, j, g) if plan is None else
                    _rd.row_delta(d1, s1, j, g, plan=plan))
    delta2, old2 = ops.row_delta(data, scale, j, g, backend="torch")
    torch.cuda.synchronize()
    assert torch.equal(d1, data)
    assert _same(s1, scale)
    assert _same(delta1, delta2) and _same(old1, old2)


def check_ace(data, scale, j, g, u, inv_n=0.01, plan=None):
    """The whole int8 ACE step on a copy of the cache against its plain
    version on another: every row and scale and u' bit for bit, u' in u's
    dtype, the input u untouched. Returns u'."""
    d1, s1, u_in = data.clone(), scale.clone(), u.clone()
    u1 = (ops.cache_row_update(d1, s1, j, g, u, inv_n) if plan is None else
          _cu.cache_row_update(d1, s1, j, g, u, inv_n, plan=plan))
    u2 = ops.cache_row_update(data, scale, j, g, u, inv_n, backend="torch")
    torch.cuda.synchronize()
    assert torch.equal(d1, data)
    assert _same(s1, scale)
    assert u1.dtype == u.dtype and _same(u1.float(), u2.float())
    assert _same(u.float(), u_in.float())
    return u1


@pytest.mark.parametrize("d", [1, 300, 17226, (1 << 24) + 3])
def test_row_kernels_match_plain(cuda, d):
    """The row swap and the whole int8 ACE step (f32 and bf16 states)
    against their plain versions, one launch each."""
    _, g, *_ = row_inputs(8, d, cuda)
    data, scale = swap_cache(d, 3, d, cuda)
    gen = torch.Generator().manual_seed(d)
    before = ops.launch_counts()
    check_swap(data, scale, torch.tensor([1], device=cuda), g)
    for dtype in (torch.float32, torch.bfloat16):
        u = torch.randn(d, generator=gen).to(cuda, dtype)
        check_ace(data, scale, torch.tensor([2], device=cuda), g, u)
    after = ops.launch_counts()
    assert after["row_delta"] == before["row_delta"] + 1
    assert after["cache_row_update"] == before["cache_row_update"] + 2


def ace_plans(d, sms):
    """Every launch plan the whole ACE step takes at width d: each cluster
    size whose slices fit its registers at `MAX_PER_THREAD` vectors a
    thread, and the cooperative grid."""
    plans = []
    for cluster in (1, 2, 4, 8):
        plan = _q._quant_plan(1, d, sms, cluster)
        if plan[3] == "registers" and plan[2] <= _cu.MAX_PER_THREAD:
            plans.append(plan)
    return plans + [(1, 32, 2, "grid")]


@pytest.mark.parametrize("state", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("j", [1, 2])
@pytest.mark.parametrize("d", [1, 7, 300, 17226, (1 << 24) + 3])
def test_whole_ace_step_matches_plain(cuda, d, j, state):
    """The whole int8 ACE step 50 times over on one row (odd rows of an even
    d are only 2-byte aligned, even ones 4-byte), u' carried into the next
    call, with payloads whose scale changes by orders of magnitude from call
    to call, so that a block that read the new scale as the old one would
    show in u'. Every fifth payload and every third u lie 4-12 bytes into
    their allocation; every fourth payload holds a NaN or ±inf (codes 0;
    u' is NaN there and in the next call, whose old scale is NaN or inf:
    u restarts from a finite vector). The calls go round every cluster size
    that fits and the cooperative grid, forced through plan=; each call is
    one launch."""
    data, scale = swap_cache(d + j, 4, d, cuda)
    row = torch.tensor([j], device=cuda)
    gen = torch.Generator().manual_seed(d + j)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    plans = ace_plans(d, sms) if d < 1 << 20 else [None]
    u = torch.randn(d, generator=gen).to(cuda, state)
    for it in range(50):
        g = torch.randn(d, generator=gen) * 10.0 ** (it % 7 - 3)
        special = (float("nan"), float("inf"), -float("inf"))[it % 3]
        if it % 4 == 3:
            g[(it * 7919) % d] = special
        g = g.to(cuda)
        if it % 5 == 4:
            g = _offset(g, 1 + it % 3)
        if it % 3 == 2:
            u = _offset(u, 1 + it % 3)
        before = ops.launch_counts()["cache_row_update"]
        u = check_ace(data, scale, row, g, u, 1.0 / 4,
                      plans[it % len(plans)])
        assert ops.launch_counts()["cache_row_update"] == before + 1
        if it % 4 == 3:
            assert not bool(data[j].any())
        if not bool(torch.isfinite(u).all()):
            u = torch.randn(d, generator=gen).to(cuda, state)
    assert torch.isfinite(scale[torch.arange(4, device=cuda) != j]).all()


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [17226, (1 << 24) + 3])
def test_ace_int8_step_is_one_launch(cuda, d, state_dtype):
    """With an int8 cache, one `ACEIncremental.step` at K = 1 puts exactly
    one kernel on the card, the whole-step `cache_row_update` (a cluster's
    or the grid's): over n steps the wrapper counts n launches and the
    trace holds no other device work and no more than n such kernels (the
    profiler there sometimes drops events; an empty trace is taken
    again)."""
    agg = tagg.ACEIncremental(cache_dtype="int8", state_dtype=state_dtype)
    gen = torch.Generator().manual_seed(5)
    state = agg.init_state(6, d, (torch.randn(6, d, generator=gen) * 2)
                           .to(cuda))
    client = torch.tensor([3], device=cuda)
    payload = torch.randn(d, generator=gen).to(cuda)
    arr = tagg.Arrival(client, payload, 1, 0)
    state, *_ = agg.step(state, arr)            # build and load first
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    n = 20
    for _ in range(3):
        before = ops.launch_counts()["cache_row_update"]
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(n):
                state, *_ = agg.step(state, arr)
            torch.cuda.synchronize()
        assert ops.launch_counts()["cache_row_update"] == before + n
        on_card = [e.name for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        if on_card:
            break
    assert 0 < len(on_card) <= n, on_card
    assert all("cache_update" in name for name in on_card), on_card


@pytest.mark.parametrize("j", [1, 2])
@pytest.mark.parametrize("d", [1, 7, 300, 17226, (1 << 24) + 3])
def test_row_delta_swap_matches_plain(cuda, d, j):
    """The fused row swap, 50 times over on one row (odd rows of an even d
    are only 2-byte aligned, even ones 4-byte) with payloads whose scale
    changes by orders of magnitude from call to call, so that a block that
    read the new scale as the old one would show in `old`; every fifth
    payload at a 4-12 byte offset, some holding a NaN or ±inf (codes 0).
    Rows that fit a cluster's registers also take the cooperative grid
    (which the plan keeps for longer rows) every other call."""
    data, scale = swap_cache(d + j, 4, d, cuda)
    row = torch.tensor([j], device=cuda)
    gen = torch.Generator().manual_seed(d)
    grid = (1, 32, 2, "grid")
    for it in range(50):
        g = torch.randn(d, generator=gen) * 10.0 ** (it % 7 - 3)
        special = (float("nan"), float("inf"), -float("inf"))[it % 3]
        if it % 4 == 3:
            g[(it * 7919) % d] = special
        g = g.to(cuda)
        if it % 5 == 4:
            g = _offset(g, 1 + it % 3)
        check_swap(data, scale, row, g, grid if it % 2 and d < 1 << 20
                   else None)
        if it % 4 == 3:
            assert not bool(data[j].any())
    assert torch.isfinite(scale[torch.arange(4, device=cuda) != j]).all()


@pytest.mark.parametrize("kind", ["nan", "+inf", "-inf"])
def test_quantizing_kernels_code_nan_and_inf_rows_as_0(cuda, kind):
    """A row that holds a NaN (scale NaN) or ±inf (scale inf) gets int8
    codes 0 from all four quantizing kernels, as the JAX package gives it,
    and the same codes as the plain versions."""
    d = 17226
    x = quant_rows(3, 3, d, cuda)
    x[0, [5, d // 2, d - 2]] = {"nan": float("nan"), "+inf": float("inf"),
                                "-inf": -float("inf")}[kind]
    q1, s1 = ops.quantize_rows(x)
    q0, s0 = ops.quantize_rows(x, backend="torch")
    assert torch.equal(q1, q0) and _same(s1, s0)
    assert not bool(q1[0].any())
    data, scale = swap_cache(1, 4, d, cuda)
    check_swap(data, scale, torch.tensor([1], device=cuda), x[0])
    for dtype in (torch.float32, torch.bfloat16):
        data, scale = swap_cache(2, 4, d, cuda)
        u = row_inputs(2, d, cuda)[0].to(dtype)
        check_ace(data, scale, torch.tensor([2], device=cuda), x[0], u)
        assert not bool(data[2].any())
    kw = commit_inputs(3, 16, d, 3, torch.int8, ("a", "g"), cuda,
                       valid=torch.ones(16, dtype=torch.bool))
    kw["G"][0] = x[0]
    kw["new_s"] = tref.row_scale(kw["G"])
    r1, _, _ = ops.commit_batch(**kw)
    r2, _, _ = ops.commit_batch(**kw, backend="torch")
    torch.cuda.synchronize()
    assert torch.equal(r1, r2) and not bool(r1[0].any())


@pytest.mark.parametrize("kind", ["nan", "+inf", "-inf"])
def test_op_chain_row_swap_codes_nan_and_inf_lanes_as_0(cuda, kind):
    """The op chain's K-lane swap `FlatCache.set_rows_delta` (int8 K > 1
    steps with a bf16 state, or with the fused commit off) quantizes in
    PyTorch ops, not in a kernel: a valid lane holding a NaN or ±inf gets
    int8 codes 0 and the scale (NaN, inf) the CPU path gives, as the JAX
    package does; every other row, scale, delta and old row is the CPU
    path's too."""
    n, d = 6, 17226
    g = torch.Generator().manual_seed(5)
    init = torch.randn((n, d), generator=g)
    G = torch.randn((4, d), generator=g) * 3
    G[1, [5, d // 2, d - 2]] = {"nan": float("nan"), "+inf": float("inf"),
                                "-inf": -float("inf")}[kind]
    idx = torch.tensor([4, 0, 2, 5])
    valid = torch.tensor([True, True, False, True])
    outs = []
    for dev in (torch.device("cpu"), cuda):
        cache = FlatCache(*tref.quantize_rows_ref(init.to(dev)))
        _, delta, old = cache.set_rows_delta(idx.to(dev), G.to(dev),
                                             valid.to(dev))
        outs.append([t.cpu() for t in (cache.data, cache.scale, delta, old)])
    (q0, s0, d0, o0), (q1, s1, d1, o1) = outs
    assert not bool(q0[0].any()) and not bool(q1[0].any())
    assert torch.equal(q1, q0)
    assert _same(s1, s0) and not bool(torch.isfinite(s1[0]))
    assert _same(d1, d0) and _same(o1, o0)


def commit_inputs(seed, K, d, R, dtype, lanes, device, valid=None):
    """Aggregator calling convention: lane weights zero on invalid lanes,
    `new_s` from the sanitized payloads; invalid lanes' payloads are NaN."""
    g = torch.Generator().manual_seed(seed)
    G = torch.randn(K, d, generator=g) * 3
    if valid is None:
        valid = torch.rand(K, generator=g) < 0.7
    valid = torch.as_tensor(valid)
    G[~valid] = float("nan")
    rows = torch.randn(K, d, generator=g)
    kw = dict(G=G, valid=valid, vecs=torch.randn(R, d, generator=g),
              coef=torch.randn(R, R + 4, generator=g),
              upd_w=torch.randn(R + 4, generator=g))
    if dtype == torch.int8:
        q, s = tref.quantize_rows_ref(rows)
        kw.update(old_rows=q, old_s=s, new_s=tref.row_scale(
            torch.where(valid[:, None], G, 0.0)))
    else:
        kw.update(old_rows=rows.to(dtype), old_s=None, new_s=None)
    for name in lanes:
        kw[f"lane_{name}"] = torch.rand(K, generator=g) * valid
    return {k: (v.to(device) if v is not None else None)
            for k, v in kw.items()}


# R -> the lane weights of the rule with R running-sum vectors
RULE_LANES = {1: (), 2: ("a", "b"), 3: ("a", "g")}   # ACE, ACED, CA²FL
# every residue of d mod 4, widths below one warp, a ragged last block and
# the engine's width; K on both sides of the K = 16 instantiation
EDGE_CASES = [(K, d, R, dtype, RULE_LANES[R])
              for dtype in (torch.int8, torch.float32, torch.bfloat16)
              for d in (1, 3, 5, 128, 130, 17226)
              for K in (1, 2, 15, 16, 17)
              for R in (1, 2, 3)]


@pytest.mark.parametrize("K,d,R,dtype,lanes", [
    (16, 17226, 1, torch.int8, ()),                 # ACE
    (16, 17226, 2, torch.int8, ("a", "b")),         # ACED
    (16, 17226, 3, torch.int8, ("a", "g")),         # CA²FL
    (16, (1 << 24) + 3, 3, torch.int8, ("a", "g")),
    (4, 1000, 3, torch.float32, ("a", "b", "g")),
    (3, 777, 2, torch.bfloat16, ("a",)),
    (1, 1, 1, torch.int8, ("g",)),
] + EDGE_CASES)
def test_commit_batch_matches_plain(cuda, K, d, R, dtype, lanes):
    kw = commit_inputs(5 + K, K, d, R, dtype, lanes, cuda)
    r1, v1, u1 = ops.commit_batch(**kw)
    r2, v2, u2 = ops.commit_batch(**kw, backend="torch")
    torch.cuda.synchronize()
    assert torch.equal(r1, r2)
    assert torch.isfinite(v1).all() and torch.isfinite(u1).all()
    _close(v1, v2)
    _close(u1, u2)


@pytest.mark.parametrize("dtype", [torch.int8, torch.float32,
                                   torch.bfloat16])
@pytest.mark.parametrize("operand,offset", [("G", 1), ("old_rows", 2)])
def test_commit_batch_offset_operands(cuda, dtype, operand, offset):
    """An operand that starts `offset` elements into its storage (a
    contiguous view) is read where it lies: the kernel matches the plain
    version bit for bit whatever the operands' alignment."""
    K, d = 16, 1030
    kw = commit_inputs(11, K, d, 3, dtype, ("a", "g"), cuda)
    x = kw[operand]
    flat = torch.empty(K * d + offset, dtype=x.dtype, device=cuda)
    kw[operand] = flat[offset:].view(K, d).copy_(x)
    r1, v1, u1 = ops.commit_batch(**kw)
    r2, v2, u2 = ops.commit_batch(**kw, backend="torch")
    torch.cuda.synchronize()
    assert torch.equal(r1, r2)
    _close(v1, v2)
    _close(u1, u2)


@pytest.mark.parametrize("dtype", [torch.int8, torch.float32])
@pytest.mark.parametrize("K", [16, 17])
def test_commit_batch_is_one_launch(cuda, dtype, K):
    """One `ops.commit_batch` call puts exactly one kernel on the card: the
    lane scalars and the recombination reach it as their own tensors. Over
    n calls the wrapper counts n launches, and the trace holds no other
    device work and no more than n commit kernels. (The profiler on the
    H100 machine sometimes drops events, so the trace may hold fewer, and a
    trace with none at all is taken again.)"""
    kw = commit_inputs(4, K, 17226, 3, dtype, ("a", "g"), cuda)
    ops.commit_batch(**kw)          # build and load the library first
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    n = 20
    for _ in range(3):
        before = ops.launch_counts()["commit_batch"]
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(n):
                ops.commit_batch(**kw)
            torch.cuda.synchronize()
        assert ops.launch_counts()["commit_batch"] == before + n
        on_card = [e.name for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        if on_card:
            break
    assert 0 < len(on_card) <= n, on_card
    assert all("commit_batch_kernel" in name for name in on_card), on_card


@pytest.mark.parametrize("K,d", [(16, 17226), (16, 40000), (17, 1000)])
def test_commit_batch_rounding_ties(cuda, K, d):
    """Payloads on int8 rounding ties (power-of-two scales make g / s an
    exact half-integer), a few ulps off them, on both sides of the kernel's
    1e-4 tie margin, past the ±127 clip, and on a lane whose subnormal
    scale has no finite reciprocal: the codes must be the plain version's,
    which divides."""
    kw = commit_inputs(2, K, d, 3, torch.int8, ("a", "g"), cuda)
    g = torch.Generator().manual_seed(K + d)
    pow2 = 2.0 ** -torch.randint(3, 9, (K,), generator=g).float()
    scales = torch.where(torch.arange(K) % 2 == 0, pow2,
                         torch.rand(K, generator=g) * 0.05 + 1e-3)
    scales[1] = 1e-40
    kw["valid"][1] = True
    n = torch.randint(-131, 131, (K, d), generator=g).float()
    offsets = torch.tensor([0.0, 0.0, 0.0, 2.0 ** -20, -2.0 ** -20, 1e-5,
                            -1e-5, 9e-5, -9e-5, 1.1e-4, -1.1e-4, 0.3])
    pick = torch.randint(len(offsets), (K, d), generator=g)
    G = (n + 0.5 + offsets[pick]) * scales[:, None]
    valid = kw["valid"].cpu()
    G[~valid] = float("nan")
    kw.update(G=G.to(cuda), new_s=scales.to(cuda))
    r1, v1, u1 = ops.commit_batch(**kw)
    r2, v2, u2 = ops.commit_batch(**kw, backend="torch")
    torch.cuda.synchronize()
    assert torch.equal(r1, r2)
    _close(v1, v2)
    _close(u1, u2)


def test_commit_batch_all_masked_batch(cuda):
    kw = commit_inputs(9, 16, 17226, 2, torch.int8, ("a", "b"), cuda,
                       valid=torch.zeros(16, dtype=torch.bool))
    r1, v1, u1 = ops.commit_batch(**kw)
    torch.cuda.synchronize()
    assert torch.equal(r1, kw["old_rows"])
    _close(v1, kw["coef"][:, :2] @ kw["vecs"], 1e-5)


def quant_rows(seed, n, d, device):
    """Rows of mixed magnitudes, one all-zero row and one row of half-way
    ties (max|x| = 127 makes its scale exactly 1.0)."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(n, d, generator=g) * torch.rand(n, 1, generator=g) * 50
    if n > 1:
        x[1] = 0.0
    if n > 2:
        ties = torch.tensor([127.0, 2.5, -0.5, 1.5, 3.5, -2.5, 0.5, -126.5])
        x[2] = ties.repeat(d // 8 + 1)[:d]
    return x.to(device)


QUANT_SHAPES = [(1, 1), (1, 3), (1, 4), (1, 5), (2, 7), (1, 17226),
                (1, 17227), (3, 1), (100, 17226), (100, (1 << 22) + 3)]


def _offset(t, offset):
    """A contiguous copy of `t` that starts `offset` elements into its
    allocation."""
    buf = torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)
    view = buf[offset:offset + t.numel()].view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.parametrize("n,d", QUANT_SHAPES)
def test_quant_kernels_match_plain(cuda, n, d):
    """Both kernels bit-identical to their plain versions (the dequantizer
    also to torch.mul), one launch each, with x at every 4-byte phase of a
    16-byte line and q at every byte phase of a 4-byte word and at each
    4-byte phase of a 16-byte line."""
    x0 = quant_rows(n + d % 7, n, d, cuda)
    q0, s0 = ops.quantize_rows(x0, backend="torch")
    before = ops.launch_counts()
    q1, s1 = ops.quantize_rows(x0)
    x1 = ops.dequantize_rows(q1, s1)
    torch.cuda.synchronize()
    after = ops.launch_counts()
    assert after["quantize_rows"] == before["quantize_rows"] + 1
    assert after["dequantize_rows"] == before["dequantize_rows"] + 1
    assert torch.equal(q1, q0) and torch.equal(s1, s0)
    assert torch.equal(x1, ops.dequantize_rows(q0, s0, backend="torch"))
    assert torch.equal(x1, torch.mul(q0, s0[:, None]))
    # the scale is a true division, the same bits as on the CPU
    assert torch.equal(s1.cpu(), tref.row_scale(x0.cpu()))
    for off in (1, 2, 3):
        q2, s2 = ops.quantize_rows(_offset(x0, off))
        assert torch.equal(q2, q0) and torch.equal(s2, s0)
    for off in (1, 2, 3, 4, 8, 12):     # byte loads, then aligned heads
        assert torch.equal(ops.dequantize_rows(_offset(q0, off), s0), x1)
    torch.cuda.synchronize()


@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
@pytest.mark.parametrize("n,d", [(2, 7), (1, 17227), (3, 17226),
                                 (2, 100003)])
def test_quantize_rows_every_plan(cuda, n, d, cluster):
    """Each cluster size with the slice in registers, shared memory and
    streamed (where it fits), against the plain version; x also at a
    4-byte offset, so that every head/tail split is taken."""
    x = quant_rows(cluster + d, n, d, cuda)
    q0, s0 = ops.quantize_rows(x, backend="torch")
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for on_chip in ("registers", "shared", "stream"):
        try:
            plan = _q._quant_plan(n, d, sms, cluster, on_chip)
        except ValueError:      # the slice does not fit there
            continue
        for off in (0, 1, 3):
            q1, s1 = _q.quantize_rows(_offset(x, off), plan=plan)
            assert torch.equal(q1, q0) and torch.equal(s1, s0), (plan, off)


@pytest.mark.parametrize("n,d", [(1, 17226), (3, 17227), (100, 17226)])
def test_quantize_rows_nan_outside_rank_0(cuda, n, d):
    """A NaN that cluster rank 0 does not own still reaches every block's
    scale: the row's scale is NaN and all its codes are 0 (repro::quant
    codes a NaN quotient 0, as XLA's conversion does), on every cluster
    size; every row, the NaN rows included, matches the plain version."""
    x = quant_rows(5, n, d, cuda)
    nan_rows = [0, n - 1]
    x[0, d - 1] = float("nan")              # the scalar tail of rank C - 1
    x[n - 1, (3 * d) // 4] = float("nan")   # inside a later rank's slice
    q0, s0 = ops.quantize_rows(x, backend="torch")
    keep = torch.ones(n, dtype=torch.bool, device=cuda)
    keep[nan_rows] = False
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for cluster in (None, 1, 2, 4, 8):
        plan = _q._quant_plan(n, d, sms, cluster)
        q1, s1 = _q.quantize_rows(x, plan=plan)
        assert bool(torch.isnan(s1[nan_rows]).all()), plan
        assert not bool(q1[nan_rows].any()), plan
        assert torch.equal(q1, q0), plan
        assert _same(s1, s0), plan
        x1 = ops.dequantize_rows(q1, s1)
        assert bool(torch.isnan(x1[nan_rows]).all())
        assert torch.equal(x1[keep], torch.mul(q1, s1[:, None])[keep])


def test_quant_plan_refused_by_the_kernel(cuda):
    """A plan whose slices do not fit where it says is refused at launch
    (cudaErrorInvalidValue), never run."""
    x = torch.randn(1, 1 << 16, device=cuda)
    with pytest.raises(RuntimeError, match="quant kernel launch failed"):
        _q.quantize_rows(x, plan=(1, 32, 4, "registers"))


@pytest.mark.parametrize("n,d", [(100, 17226), (7, 1), (3000, 513),
                                 (100, (1 << 22) + 3), (1, 17226),
                                 (9, 1001)])
def test_masked_agg_matches_plain(cuda, n, d):
    """Bit for bit at the main path's shape, a chunked n (3000 rows), one
    row, rows at every byte phase (odd d) and a large width; with chunks of
    1 and 7 rows and with the cache at an offset (its first and last
    16-byte words reach outside it)."""
    g = torch.Generator().manual_seed(n + d)
    q, s = tref.quantize_rows_ref(torch.randn(n, d, generator=g))
    q, s = q.to(cuda), s.to(cuda)
    before = ops.launch_counts()["masked_agg"]
    for mask in (torch.rand(n, generator=g) < 0.4,
                 torch.ones(n, dtype=torch.bool),
                 torch.zeros(n, dtype=torch.bool)):
        mask = mask.to(cuda)
        u1 = ops.masked_agg(q, s, mask)
        u2 = ops.masked_agg(q, s, mask, backend="torch")
        torch.cuda.synchronize()
        assert torch.equal(u1, u2)
        if not bool(mask.any()):
            assert not bool(u1.any())
    assert ops.launch_counts()["masked_agg"] == before + 3
    if n * d < 1 << 24:
        blocks = _ma._agg_plan(n, d)[1]
        for rows in (1, 7, _ma.MAX_ROWS):
            for off in (0, 3, 10):
                u3 = _ma.masked_agg(_offset(q, off), s, mask,
                                    plan=(rows, blocks))
                torch.cuda.synchronize()
                assert torch.equal(u3, u2), (rows, off)


def test_wrappers_raise_on_operands_the_kernel_does_not_take(cuda):
    u, g, c, o, s = row_inputs(1, 64, cuda)
    data, scale = swap_cache(1, 4, 64, cuda)
    j = torch.tensor([1], device=cuda)
    with pytest.raises(TypeError, match="dtype"):
        ops.row_delta(data, scale, j, g.double())
    with pytest.raises(ValueError, match="contiguous"):
        ops.row_delta(data, scale, j, torch.randn(128, device=cuda)[::2])
    with pytest.raises(TypeError, match="CUDA tensor"):
        ops.row_delta(data, scale, j.cpu(), g)
    with pytest.raises(TypeError, match="dtype"):
        ops.row_delta(data, scale, j.int(), g)


@pytest.mark.parametrize("name,dtype,K,kernel", [
    ("ace", "int8", 1, "cache_row_update"),
    ("aced", "int8", 1, "row_delta"),
    ("ca2fl", "int8", 1, "row_delta"),
    ("ace", "int8", 4, "commit_batch"),
    ("aced", "float32", 4, "commit_batch"),
    ("ca2fl", "int8", 4, "commit_batch"),
])
def test_engine_runs_through_the_kernels(cuda, name, dtype, K, kernel):
    """A short run of the engine on the card launches the rule's kernel and
    ends where the same run through the plain versions ends."""
    task = make_vision_task(n_clients=8, batch=6, dim=8, hidden=(16, 8),
                            n_train=400, n_test=100, device=cuda)

    def run(backend):
        agg = {"ace": tagg.ACEIncremental(cache_dtype=dtype, backend=backend),
               "aced": tagg.ACED(tau_algo=4, cache_dtype=dtype, max_cohort=K,
                                 backend=backend),
               "ca2fl": tagg.CA2FL(buffer_size=3, cache_dtype=dtype,
                                   backend=backend)}[name]
        return run_staleness_scan(grad_fn=task.grad_fn,
                                  params0=task.params0, aggregator=agg,
                                  n_clients=8, server_lr=0.2, T=20,
                                  beta=2.0, k_batch=K, seed=3)
    ops.reset_launch_counts()
    r_kernel = run(None)
    assert ops.launch_counts()[kernel] > 0
    if kernel == "cache_row_update":
        # the whole step: one launch a tick, the first tick (which warms
        # the graph up before its capture) and the replayed ones
        assert ops.launch_counts()[kernel] == len(r_kernel.emit)
    ops.reset_launch_counts()
    r_plain = run("torch")
    assert sum(ops.launch_counts().values()) == 0
    assert np.isfinite(r_kernel.w).all()
    np.testing.assert_allclose(r_kernel.w, r_plain.w, rtol=1e-4, atol=1e-5)
    acc = task.eval_fn(unravel(torch.as_tensor(r_kernel.w, device=cuda),
                               task.params0))
    assert 0.0 <= acc["accuracy"] <= 1.0


@pytest.mark.parametrize("name,dtype,kernels", [
    ("aced_direct", "int8", ("masked_agg", "quantize_rows")),
    ("ace_direct", "int8", ("quantize_rows", "dequantize_rows")),
    ("ca2fl_direct", "int8", ("quantize_rows", "dequantize_rows")),
    ("aced_direct", "float32", ()),
    ("fedbuff", "float32", ()),
    ("delay_asgd", "float32", ()),
])
def test_zoo_engine_runs_through_the_kernels(cuda, name, dtype, kernels):
    """The direct rules' int8 ticks launch masked_agg and the quantizer and
    dequantizer; the run through the plain versions ends bit for bit where
    the kernels' run ends (every sum is taken in the kernels' order)."""
    task = make_vision_task(n_clients=8, batch=6, dim=8, hidden=(16, 8),
                            n_train=400, n_test=100, device=cuda)

    def run(backend):
        agg = {"aced_direct": tagg.ACEDDirect(tau_algo=4, cache_dtype=dtype,
                                              backend=backend),
               "ace_direct": tagg.ACEDirect(cache_dtype=dtype,
                                            backend=backend),
               "ca2fl_direct": tagg.CA2FLDirect(buffer_size=3,
                                                cache_dtype=dtype,
                                                backend=backend),
               "fedbuff": tagg.FedBuff(buffer_size=3),
               "delay_asgd": tagg.DelayAdaptiveASGD(tau_c=2.0)}[name]
        return run_staleness_scan(grad_fn=task.grad_fn,
                                  params0=task.params0, aggregator=agg,
                                  n_clients=8, server_lr=0.2, T=20,
                                  beta=2.0, seed=3)
    ops.reset_launch_counts()
    r_kernel = run(None)
    counts = ops.launch_counts()
    assert all(counts[k] > 0 for k in kernels)
    ops.reset_launch_counts()
    r_plain = run("torch")
    assert sum(ops.launch_counts().values()) == 0
    assert np.isfinite(r_kernel.w).all()
    assert np.array_equal(r_kernel.w, r_plain.w)


# --- the graph runner: the tick captured as one CUDA graph -----------------

GRAPH_RULES = ([(r, dt, K) for r in ("ace", "aced", "ca2fl")
                for dt in ("int8", "float32") for K in (1, 16)]
               + [(r, None, K) for r in ("asgd", "delay_asgd", "fedbuff")
                  for K in (1, 16)]
               + [(r, dt, 1) for r in ("ace_direct", "aced_direct",
                                       "ca2fl_direct")
                  for dt in ("int8", "float32")])


def _rule(name, dtype, K):
    return {"ace": lambda: tagg.ACEIncremental(cache_dtype=dtype),
            "aced": lambda: tagg.ACED(tau_algo=4, cache_dtype=dtype,
                                      max_cohort=K),
            "ca2fl": lambda: tagg.CA2FL(buffer_size=3, cache_dtype=dtype),
            "asgd": tagg.VanillaASGD,
            "delay_asgd": lambda: tagg.DelayAdaptiveASGD(tau_c=2.0),
            "fedbuff": lambda: tagg.FedBuff(buffer_size=3),
            "ace_direct": lambda: tagg.ACEDirect(cache_dtype=dtype),
            "aced_direct": lambda: tagg.ACEDDirect(tau_algo=4,
                                                   cache_dtype=dtype),
            "ca2fl_direct": lambda: tagg.CA2FLDirect(buffer_size=3,
                                                     cache_dtype=dtype),
            }[name]()


def _streams(grad_fn, n, K, E, device, seed=3, windows=None):
    rand = build_staleness_randomness(seed, E, n, 2.0, k_batch=K,
                                      windows=windows, device=device)
    return rand, build_payload_noise(grad_fn, seed, E, n, K, device=device)


def _same_result(a, b):
    """Two runner results bit for bit: model, every state tensor (cache
    rows and scales included) and every per-event output."""
    (w1, s1, o1, _), (w2, s2, o2, _) = a, b
    assert torch.equal(w1, w2)
    assert s1.keys() == s2.keys()
    for k in s1:
        if isinstance(s1[k], FlatCache):
            assert torch.equal(s1[k].data, s2[k].data)
            assert torch.equal(s1[k].scale, s2[k].scale)
        else:
            assert torch.equal(s1[k], s2[k])
    assert o1.keys() == o2.keys()
    assert all(torch.equal(o1[k], o2[k]) for k in o1)


@pytest.mark.parametrize("name,dtype,K", GRAPH_RULES)
def test_graph_run_matches_eager(cuda, name, dtype, K):
    """Every rule of the zoo, int8 and f32 caches, K = 1 and 16: the tick
    replayed from one captured CUDA graph ends bit for bit where the eager
    tick ends (model, cache rows and scales, running sums, every per-event
    output), and a replayed call's launch counts are the eager call's."""
    n = 20
    task = make_vision_task(n_clients=n, batch=6, dim=8, hidden=(16, 8),
                            n_train=400, n_test=100, device=cuda)
    rand, noise = _streams(task.grad_fn, n, K, 30, cuda)
    kw = dict(grad_fn=task.grad_fn, params0=task.params0, n_clients=n, T=20,
              beta=2.0, k_batch=K, device=cuda)
    graph = make_staleness_runner(aggregator=_rule(name, dtype, K),
                                  graph=True, **kw)
    eager = make_staleness_runner(aggregator=_rule(name, dtype, K),
                                  graph=False, **kw)
    first = graph(rand, noise, 0.2)
    ops.reset_launch_counts()
    replayed = graph(rand, noise, 0.2)
    replay_counts = ops.launch_counts()
    ops.reset_launch_counts()
    ref = eager(rand, noise, 0.2)
    assert ops.launch_counts() == replay_counts
    assert graph.captures == 1
    _same_result(first, ref)
    _same_result(replayed, ref)
    assert torch.isfinite(ref[0]).all()


def _quadratic(n, d, device, seed=0):
    """g = w − C[client] + 0.3·ξ, ξ ~ N(0, I) from the payload noise."""
    gen = torch.Generator().manual_seed(seed)
    C = (torch.randn(n, d, generator=gen) * 3).to(device)

    def grad(w, clients, noise):
        return (torch.zeros(w.shape[0], device=w.device),
                w - C[clients] + 0.3 * noise)
    return ClientGrad(grad, (d,), "normal")


@pytest.mark.parametrize("name,d", [("ace", 70_000), ("aced", 140_000)])
def test_graph_run_at_the_grid_widths(cuda, name, d):
    """Rows past the cluster kernels' reach take the cooperative grid
    (int8 ACE past 65,536 features, the row swap past 131,072): the
    captured grid launches replay bit for bit like the eager ones."""
    n, K = 6, 1
    grad = _quadratic(n, d, cuda)
    rand, noise = _streams(grad, n, K, 24, cuda)
    kw = dict(grad_fn=grad, params0=torch.ones(d, device=cuda),
              n_clients=n, T=20, beta=2.0, device=cuda)
    results = [make_staleness_runner(aggregator=_rule(name, "int8", K),
                                     graph=g, **kw)(rand, noise, 0.1)
               for g in (True, False)]
    _same_result(*results)


@pytest.mark.parametrize("name,dtype,K", [("ace", "int8", 1),
                                          ("aced", "int8", 16),
                                          ("ca2fl", "float32", 1)])
def test_chunked_graph_run_matches_one_graph_run(cuda, name, dtype, K):
    """Three chunks of a captured tick (one slice split inside the
    availability window's freeze) end bit for bit where one graph run
    ends."""
    n, E = 20, 40
    task = make_vision_task(n_clients=n, batch=6, dim=8, hidden=(16, 8),
                            n_train=400, n_test=100, device=cuda)
    windows = (np.full(n, 8, np.int32), np.full(n, 12, np.int32))
    rand, noise = _streams(task.grad_fn, n, K, E, cuda, windows=windows)
    kw = dict(grad_fn=task.grad_fn, params0=task.params0, n_clients=n, T=30,
              beta=2.0, k_batch=K, device=cuda)
    whole = make_staleness_runner(aggregator=_rule(name, dtype, K), **kw)(
        rand, noise, 0.2)
    chunked = make_chunked_staleness_runner(
        aggregator=_rule(name, dtype, K), capacity=16, **kw)
    carry, outs = chunked.init(0.2, noise.init), []
    for a, b in ((0, 9), (9, 25), (25, E)):
        carry, o = chunked.chunk(carry, rand.slice(a, b), noise.ticks[a:b],
                                 0.2)
        outs.append(o)
    assert int(carry["e"]) == E
    _same_result(whole, (carry["w"], carry["state"],
                         {k: torch.cat([o[k] for o in outs]) for k in
                          outs[0]}, None))


def test_graph_second_lr_replays_without_a_new_capture(cuda):
    """The lr is the runner's own buffer: a second lr replays the same
    graph (no capture) and ends where a fresh runner with that lr ends."""
    n = 20
    task = make_vision_task(n_clients=n, batch=6, dim=8, hidden=(16, 8),
                            n_train=400, n_test=100, device=cuda)
    rand, noise = _streams(task.grad_fn, n, 1, 30, cuda)
    kw = dict(grad_fn=task.grad_fn, params0=task.params0, n_clients=n, T=20,
              beta=2.0, device=cuda)

    def runner():
        return make_staleness_runner(
            aggregator=tagg.ACEIncremental(cache_dtype="int8"), **kw)
    r = runner()
    a = r(rand, noise, 0.2)
    b = r(rand, noise, torch.tensor(0.05, device=cuda))
    assert r.captures == 1
    _same_result(a, runner()(rand, noise, 0.2))
    _same_result(b, runner()(rand, noise, 0.05))
    assert not torch.equal(a[0], b[0])


def test_graph_capture_of_a_host_reading_server_lr_raises(cuda):
    """A server_lr that reads the host cannot be captured: the runner
    raises and does not fall back to the eager tick."""
    n = 8
    task = make_vision_task(n_clients=n, batch=6, dim=8, hidden=(16, 8),
                            n_train=400, n_test=100, device=cuda)
    rand, noise = _streams(task.grad_fn, n, 1, 10, cuda)
    runner = make_staleness_runner(
        grad_fn=task.grad_fn, params0=task.params0,
        aggregator=tagg.ACEIncremental(cache_dtype="int8"), n_clients=n,
        T=8, beta=2.0, server_lr=lambda t: 0.1 / (1 + t.item()),
        device=cuda)
    with pytest.raises(RuntimeError):
        runner(rand, noise)
    assert runner.captures == 0


# --- the guard pipeline, resync and sweeps in the captured tick ------------

RATES = dict(nan_rate=0.05, explode_rate=0.05, byzantine_rate=0.05,
             overstale_rate=0.05)


def _same_faulted(a, b):
    """`_same_result` for faulted runs: a quarantined event's update norm
    is NaN in both."""
    (w1, s1, o1, x1), (w2, s2, o2, x2) = a, b
    _same_result((w1, s1, {}, None), (w2, s2, {}, None))
    assert o1.keys() == o2.keys()
    assert all(_same(o1[k].float(), o2[k].float()) for k in o1)
    assert {k: int(v) for k, v in x1["guards"].items()} == \
        {k: int(v) for k, v in x2["guards"].items()}


@pytest.mark.parametrize("name,dtype,K", GRAPH_RULES)
def test_faulted_graph_run_matches_eager(cuda, name, dtype, K):
    """NaN, exploding, Byzantine and over-stale clients under quarantine,
    clipping and rejection, resync every 4th update: the replayed tick ends
    bit for bit where the eager tick ends (NaN rows written by the K = 1
    kernels and restored, NaN lanes zeroed by commit_batch), the counters
    equal the flags' sums, and the model is finite."""
    n, E = 20, 40
    task = make_vision_task(n_clients=n, batch=6, dim=8, hidden=(16, 8),
                            n_train=400, n_test=100, device=cuda)
    rand, noise = _streams(task.grad_fn, n, K, E, cuda)
    fa = build_fault_schedule(3, E, k_batch=K, device=cuda, **RATES)
    kw = dict(grad_fn=task.grad_fn, params0=task.params0, n_clients=n, T=30,
              beta=2.0, tau_max=6, k_batch=K, guards=True, resync_every=4,
              device=cuda)
    runs = [make_staleness_runner(aggregator=_rule(name, dtype, K),
                                  graph=g, **kw)(rand, noise, 0.2, fa, 1.0)
            for g in (True, False)]
    _same_faulted(*runs)
    w, _, outs, extras = runs[0]
    assert torch.isfinite(w).all()
    for k, total in extras["guards"].items():
        assert int(outs[k].sum()) == int(total)
    assert int(extras["guards"]["quarantined"]) > 0


@pytest.mark.parametrize("name,dtype,K", [("ace", "int8", 1),
                                          ("ace", "int8", 16),
                                          ("aced", "int8", 1),
                                          ("ca2fl", "float32", 16)])
def test_graph_guards_on_a_clean_schedule_equal_guards_off(cuda, name,
                                                           dtype, K):
    """Guards on with an all-clean schedule and the clip off replay bit
    for bit like the unguarded graph (× 1.0 is an identity)."""
    n, E = 20, 30
    task = make_vision_task(n_clients=n, batch=6, dim=8, hidden=(16, 8),
                            n_train=400, n_test=100, device=cuda)
    rand, noise = _streams(task.grad_fn, n, K, E, cuda)
    kw = dict(grad_fn=task.grad_fn, params0=task.params0, n_clients=n, T=20,
              beta=2.0, k_batch=K, device=cuda)
    off = make_staleness_runner(aggregator=_rule(name, dtype, K), **kw)(
        rand, noise, 0.2)
    w, state, outs, _ = make_staleness_runner(
        aggregator=_rule(name, dtype, K), guards=True, **kw)(
        rand, noise, 0.2, no_faults(E, K, device=cuda), 0.0)
    _same_result(off, (w, state, {k: outs[k] for k in off[2]}, None))
    assert all(int(outs[k].sum()) == 0 for k in ("quarantined", "clipped",
                                                  "rejected"))


def test_graph_one_capture_serves_a_grid(cuda):
    """A faulted 2 × 2 lr × seed grid through one runner: one capture, and
    each cell ends where `run_staleness_scan` with that seed and lr ends."""
    n = 20
    task = make_vision_task(n_clients=n, batch=6, dim=8, hidden=(16, 8),
                            n_train=400, n_test=100, device=cuda)
    kw = dict(grad_fn=task.grad_fn, params0=task.params0,
              aggregator=tagg.ACED(tau_algo=4, cache_dtype="int8"),
              n_clients=n, T=20, beta=2.0, n_events=40, device=cuda)
    runner = make_staleness_runner(
        grad_fn=task.grad_fn, params0=task.params0,
        aggregator=kw["aggregator"], n_clients=n, T=20, beta=2.0,
        guards=True, device=cuda)
    grid = run_staleness_grid(lrs=(0.1, 0.2), seeds=(1, 2), runner=runner,
                              fault_rates=RATES, clip_norm=1.0, **kw)
    assert runner.captures == 1
    for i, lr in enumerate((0.1, 0.2)):
        for j, seed in enumerate((1, 2)):
            one = run_staleness_scan(
                seed=seed, server_lr=lr, clip_norm=1.0,
                faults=build_fault_schedule(seed, 40, device=cuda, **RATES),
                **kw)
            assert np.array_equal(grid[i][j].w, one.w)
            assert np.array_equal(grid[i][j].emit, one.emit)
            assert grid[i][j].faults == one.faults


def test_graph_clip_norm_change_needs_no_new_capture(cuda):
    """clip_norm is the runner's own buffer: a second threshold replays the
    same graph and ends where a fresh runner with that threshold ends."""
    n, E = 20, 30
    task = make_vision_task(n_clients=n, batch=6, dim=8, hidden=(16, 8),
                            n_train=400, n_test=100, device=cuda)
    rand, noise = _streams(task.grad_fn, n, 1, E, cuda)
    fa = build_fault_schedule(3, E, device=cuda, **RATES)
    kw = dict(grad_fn=task.grad_fn, params0=task.params0, n_clients=n, T=20,
              beta=2.0, guards=True, device=cuda)

    def runner():
        return make_staleness_runner(
            aggregator=tagg.ACEIncremental(cache_dtype="int8"), **kw)
    r = runner()
    a = r(rand, noise, 0.2, fa, 0.05)
    b = r(rand, noise, 0.2, fa, 5.0)
    assert r.captures == 1
    _same_faulted(a, runner()(rand, noise, 0.2, fa, 0.05))
    _same_faulted(b, runner()(rand, noise, 0.2, fa, 5.0))
    assert int(a[3]["guards"]["clipped"]) > int(b[3]["guards"]["clipped"])


# --- the event engine, the text task and the sanitize checks ----------------

EVENT_RULES = [(r, dt) for r in ("ace", "aced", "ca2fl", "aced_direct")
               for dt in ("int8", "float32")] + [("asgd", None),
                                                 ("fedbuff", None)]


@pytest.mark.parametrize("name,dtype", EVENT_RULES)
def test_graph_event_run_matches_eager(cuda, name, dtype):
    """The event engine's tick replayed from one captured graph ends bit
    for bit where the eager tick ends: model, state, every output, and
    each client's received iteration and model."""
    n = 20
    task = make_vision_task(n_clients=n, batch=6, dim=8, hidden=(16, 8),
                            n_train=400, n_test=100, device=cuda)
    sched = build_schedule(ExponentialDelays(beta=2.0, kappa=2.0,
                                             n_clients=n, seed=1), 60, 7, 1)
    noise = build_payload_noise(task.grad_fn, 1, 60, n, device=cuda)
    kw = dict(grad_fn=task.grad_fn, params0=task.params0, n_clients=n,
              server_lr=0.2, T=40, device=cuda)
    runners = [make_scan_runner(aggregator=_rule(name, dtype, 1), graph=g,
                                **kw) for g in (True, False)]
    first, ref = (r(sched.arrive, sched.dispatch, noise) for r in runners)
    again = runners[0](sched.arrive, sched.dispatch, noise)
    assert runners[0].captures == 1
    for out in (first, again):
        _same_result((*out, None), (*ref, None))
    for k in ("t", "t_recv", "w_recv"):
        assert torch.equal(runners[0].carry[k], runners[1].carry[k])


@pytest.mark.parametrize("name,dtype,K", GRAPH_RULES)
def test_host_reference_equals_the_graph_run(cuda, name, dtype, K):
    """`StalenessSimulator` driven from the host (Python ints for the
    client, t and staleness at K = 1; every rule's index and ring tensors
    made on the state's device) on the streams a graph run replays: the
    same final model, `ts` and losses, bit for bit."""
    n, T = 20, 30
    task = make_vision_task(n_clients=n, batch=6, dim=8, hidden=(16, 8),
                            n_train=400, n_test=100, device=cuda)
    agg = _rule(name, dtype, K)
    E = default_n_events(agg, T) if K == 1 else T
    rand, noise = _streams(task.grad_fn, n, K, E, cuda)
    sim = StalenessSimulator(
        grad_fn=task.grad_fn, params0=task.params0, aggregator=agg,
        n_clients=n, server_lr=0.2, beta=2.0, seed=3, replay=rand,
        payload_noise=noise, k_batch=K, device=cuda)
    hr = sim.run(T)
    runner = make_staleness_runner(
        grad_fn=task.grad_fn, params0=task.params0,
        aggregator=_rule(name, dtype, K), n_clients=n, T=T, beta=2.0,
        k_batch=K, device=cuda, graph=True)
    w, _, outs, _ = runner(rand, noise, 0.2)
    emit = outs["emit"]
    assert runner.captures == 1 and len(hr.ts) > 0
    assert torch.equal(sim.w, w)
    assert hr.ts == outs["t"][emit].tolist()
    assert hr.losses == outs["loss"][emit].tolist()


@pytest.mark.parametrize("name,dtype", [("ace", "int8"), ("aced", "int8"),
                                        ("ca2fl", "float32"),
                                        ("aced_direct", "int8")])
def test_host_event_reference_equals_the_graph_run(cuda, name, dtype):
    """`AFLSimulator` against the event engine's graph run on
    `build_schedule`'s schedule (limited concurrency), bit for bit."""
    n, T = 20, 30
    task = make_vision_task(n_clients=n, batch=6, dim=8, hidden=(16, 8),
                            n_train=400, n_test=100, device=cuda)
    E = default_n_events(_rule(name, dtype, 1), T)

    def delays():
        return ExponentialDelays(beta=2.0, kappa=2.0, n_clients=n, seed=1)
    sim = AFLSimulator(grad_fn=task.grad_fn, params0=task.params0,
                       aggregator=_rule(name, dtype, 1), n_clients=n,
                       server_lr=0.2, delays=delays(), concurrency=7, seed=1,
                       device=cuda)
    hr = sim.run(T)
    sched = build_schedule(delays(), E, 7, 1)
    runner = make_scan_runner(grad_fn=task.grad_fn, params0=task.params0,
                              aggregator=_rule(name, dtype, 1), n_clients=n,
                              server_lr=0.2, T=T, device=cuda, graph=True)
    w, _, outs = runner(sched.arrive, sched.dispatch,
                        build_payload_noise(task.grad_fn, 1, E, n,
                                            device=cuda))
    emit = outs["emit"]
    assert torch.equal(sim.w, w)
    assert hr.ts == outs["t"][emit].tolist()
    assert hr.losses == outs["loss"][emit].tolist()


@pytest.fixture(scope="module")
def text_task():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the H100)")
    return make_text_task(device=torch.device("cuda"))


@pytest.mark.parametrize("name,K", [("ace", 1), ("aced", 1), ("ace", 16)])
def test_text_task_graph_matches_eager_at_full_width(cuda, text_task, name,
                                                     K):
    """The text task at its defaults (d = 70,996, n = 20): int8 ACE K = 1
    runs cache_row_update on its cooperative grid inside the captured tick;
    graph = eager bit for bit, and two eager runs agree bit for bit (the
    embedding gradient sums without atomics)."""
    from repro_torch.kernels.cache_update import _ace_plan
    d = sum(p.numel() for p in text_task.params0.values())
    assert d == 70996 and _ace_plan(d, _q._sm_count(cuda))[3] == "grid"
    rand, noise = _streams(text_task.grad_fn, 20, K, 24, cuda)
    kw = dict(grad_fn=text_task.grad_fn, params0=text_task.params0,
              n_clients=20, T=30, beta=5.0, k_batch=K, device=cuda)
    ops.reset_launch_counts()
    graph = make_staleness_runner(aggregator=_rule(name, "int8", K),
                                  graph=True, **kw)(rand, noise, 0.5)
    counts = ops.launch_counts()
    kernel = ("commit_batch" if K > 1 else
              "cache_row_update" if name == "ace" else "row_delta")
    assert counts[kernel] > 0
    eager = [make_staleness_runner(aggregator=_rule(name, "int8", K),
                                   graph=False, **kw)(rand, noise, 0.5)
             for _ in range(2)]
    _same_result(graph, eager[0])
    _same_result(eager[0], eager[1])


def test_sanitize_checks_on_the_card(cuda):
    """Checks on are bit-identical to off (graph runs); a NaN params0 and a
    chunk whose carry holds an owner-ring slot of 9999 raise the checks'
    errors, with no device assert (the card runs on)."""
    n, E = 20, 40
    task = make_vision_task(n_clients=n, batch=6, dim=8, hidden=(16, 8),
                            n_train=400, n_test=100, device=cuda)
    rand, noise = _streams(task.grad_fn, n, 1, E, cuda)
    kw = dict(grad_fn=task.grad_fn, n_clients=n, T=30, beta=2.0,
              device=cuda)
    on, off = (make_staleness_runner(
        aggregator=_rule("aced", "int8", 1), params0=task.params0,
        checkify_invariants=c, **kw)(rand, noise, 0.2) for c in (True, False))
    _same_result(on, off)
    nan = unravel(torch.full((off[0].numel(),), float("nan"), device=cuda),
                  task.params0)
    with pytest.raises(RuntimeError, match="non-finite server model"):
        make_staleness_runner(aggregator=_rule("aced", "int8", 1),
                              params0=nan, checkify_invariants=True,
                              **kw)(rand, noise, 0.2)
    cr = make_chunked_staleness_runner(
        aggregator=_rule("aced", "int8", 1), params0=task.params0,
        checkify_invariants=True, capacity=20, **kw)
    carry, _ = cr.chunk(cr.init(0.2, noise.init), rand.slice(0, 20),
                        noise.ticks[:20], 0.2)
    bad = {**carry, "state": {**carry["state"],
                              "ring": carry["state"]["ring"].clone()}}
    bad["state"]["ring"][0] = 9999
    with pytest.raises(RuntimeError, match="owner-ring slot out of bounds"):
        cr.chunk(bad, rand.slice(20, E), noise.ticks[20:], 0.2)
    torch.cuda.synchronize()
    rest, _ = cr.chunk(carry, rand.slice(20, E), noise.ticks[20:], 0.2)
    assert torch.isfinite(rest["w"]).all()


# --- the tree layout on the card --------------------------------------------

def _same_tree_result(a, b):
    """Two tree runner results bit for bit: the model and every state
    tensor leaf by leaf (tree caches' codes and scales included) and every
    per-event output."""
    from repro_torch.convert import leaves
    (w1, s1, o1, _), (w2, s2, o2, _) = a, b
    assert s1.keys() == s2.keys() and o1.keys() == o2.keys()
    for x, y in zip(leaves((w1, s1)), leaves((w2, s2))):
        assert x.dtype == y.dtype and torch.equal(x, y)
    assert all(torch.equal(o1[k], o2[k]) for k in o1)


@pytest.mark.parametrize("name,dtype,K", GRAPH_RULES)
def test_tree_graph_run_matches_eager(cuda, name, dtype, K):
    """The nine rules on the tree layout (the vision MLP's six leaves, tree
    caches; an int8 history ring with an int8 cache): the tick replayed
    from one captured CUDA graph ends bit for bit where the eager tick
    ends, and an int8 run launches quantize_rows and dequantize_rows in
    the replays as often as eagerly."""
    n = 20
    task = make_vision_task(n_clients=n, batch=6, dim=8, hidden=(16, 8),
                            n_train=400, n_test=100, device=cuda)
    rand, noise = _streams(task.grad_fn, n, K, 30, cuda)
    kw = dict(grad_fn=task.grad_fn, params0=task.params0, n_clients=n, T=20,
              beta=2.0, k_batch=K, layout="tree",
              history_dtype="int8" if dtype == "int8" else "float32",
              device=cuda)
    graph = make_staleness_runner(aggregator=_rule(name, dtype, K),
                                  graph=True, **kw)
    eager = make_staleness_runner(aggregator=_rule(name, dtype, K),
                                  graph=False, **kw)
    first = graph(rand, noise, 0.2)
    ops.reset_launch_counts()
    replayed = graph(rand, noise, 0.2)
    replay_counts = ops.launch_counts()
    ops.reset_launch_counts()
    ref = eager(rand, noise, 0.2)
    assert ops.launch_counts() == replay_counts
    if dtype == "int8":
        assert replay_counts["quantize_rows"] > 0
        assert replay_counts["dequantize_rows"] > 0
    assert graph.captures == 1
    _same_tree_result(first, ref)
    _same_tree_result(replayed, ref)
    assert isinstance(ref[0], list)


def test_tree_int8_leaf_through_the_kernels_matches_the_cpu(cuda):
    """An int8 tree cache (a dict and a list, leaves of rank 1 and 2) on the
    card, every write and read through the quantize_rows and
    dequantize_rows kernels, against the same cache on the CPU (the plain
    versions): codes, scales, rows and deltas bit for bit; the means (a
    PyTorch reduction, in another order on each device) within 1e-6."""
    from repro_torch.convert import leaves, tree_map
    from repro_torch.core import cache as tc
    gen = torch.Generator().manual_seed(5)
    like = {"w": [torch.zeros((3, 40)), torch.zeros(17)],
            "b": torch.zeros(5)}

    def draw(lead):
        return tree_map(lambda x: torch.randn(lead + tuple(x.shape),
                                              generator=gen) * 3.0, like)
    n = 6
    init = draw((n,))
    writes = [(2, draw(())), (0, draw(()))]
    batch = (torch.tensor([4, 1, 3]), draw((3,)),
             torch.tensor([True, False, True]))
    batch[1]["w"][0][1, 0, 0] = float("nan")
    out = {}
    for dev in (torch.device("cpu"), cuda):
        def on(t):
            return tree_map(lambda x: x.to(dev), t)
        ops.reset_launch_counts()
        cache = tc.init_tree_cache(n, on(like), "int8", on(init), device=dev)
        got = [tc.cache_rows(cache, torch.arange(n, device=dev))]
        for i, g in writes:
            got += list(tc.cache_set_row_delta(cache, i, on(g))[1:])
        idx, G, valid = batch
        got += list(tc.cache_set_rows_delta(cache, idx.to(dev), on(G),
                                            valid.to(dev))[1:])
        got += [tc.cache_tensors(cache)]
        out[dev.type] = [x.cpu() for x in leaves(got)]
        out[dev.type + " mean"] = [x.cpu()
                                   for x in leaves(tc.cache_mean(cache))]
        counts = ops.launch_counts()
        if dev.type == "cuda":
            assert counts["quantize_rows"] > 0
            assert counts["dequantize_rows"] > 0
        else:
            assert sum(counts.values()) == 0
    for a, b in zip(out["cpu"], out["cuda"]):
        assert a.dtype == b.dtype and _same(a, b)
    for a, b in zip(out["cpu mean"], out["cuda mean"]):
        _close(b, a)


# --- the real models (the LM task on the tree layout) -----------------------

def _lm_task(device, n=4):
    """The reduced yi-9b LM task of tests/test_torch_lm_task.py on the
    card."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core.fl_tasks import make_lm_task
    cfg = get_config("yi-9b").reduced(layers=2, d_model=64, vocab=128)
    return make_lm_task(cfg=cfg, n_clients=n, batch=2, seq=32,
                        n_tokens=1 << 14, seed=0, device=device)


@pytest.mark.parametrize("name,K", [("ace", 1), ("aced", 3)])
def test_lm_tree_graph_run_matches_eager(cuda, name, K):
    """The reduced LM task on the tree layout with an int8 cache and an
    int8 history ring: the captured tick (each lane's forward and backward
    inside it) replays bit for bit like the eager tick, both quant kernels
    launched in the replays as often as eagerly."""
    task = _lm_task(cuda)
    rand, noise = _streams(task.grad_fn, 4, K, 16, cuda)
    kw = dict(grad_fn=task.grad_fn, params0=task.params0, n_clients=4,
              T=16, beta=2.0, k_batch=K, layout="tree", history_dtype="int8",
              device=cuda)
    rule = (lambda: tagg.ACEIncremental(cache_dtype="int8")) if name == "ace" \
        else (lambda: tagg.ACED(tau_algo=5, cache_dtype="int8", max_cohort=K))
    graph = make_staleness_runner(aggregator=rule(), graph=True, **kw)
    eager = make_staleness_runner(aggregator=rule(), graph=False, **kw)
    first = graph(rand, noise, 0.05)
    ops.reset_launch_counts()
    replayed = graph(rand, noise, 0.05)
    replay_counts = ops.launch_counts()
    ops.reset_launch_counts()
    ref = eager(rand, noise, 0.05)
    assert ops.launch_counts() == replay_counts
    assert replay_counts["quantize_rows"] > 0
    assert replay_counts["dequantize_rows"] > 0
    assert graph.captures == 1
    _same_tree_result(first, ref)
    _same_tree_result(replayed, ref)
    from repro_torch.convert import leaves
    assert all(bool(torch.isfinite(x).all()) for x in leaves(ref[0]))


def test_lm_decode_matches_forward(cuda):
    """Prefill's last logits and 16 decode steps from an empty cache on the
    card against the forward pass's logits, within 3e-3 (the JAX test's
    tolerance); the lane gradient finite and the eval loss near ln vocab at
    w⁰."""
    task = _lm_task(cuda)
    from repro_torch.configs.registry import get_config
    from repro_torch.models import build_model
    model = build_model(get_config("yi-9b").reduced(layers=2, d_model=64,
                                                    vocab=128))
    params = task.params0
    toks = torch.randint(0, 128, (2, 16), generator=torch.Generator(
        device=cuda).manual_seed(1), device=cuda, dtype=torch.int32)
    with torch.no_grad():
        logits, _ = model.forward(params, {"tokens": toks})
        last, _ = model.prefill(params, {"tokens": toks})
        cache = model.init_cache(2, 16, device=cuda)
        steps = []
        for t in range(16):
            lg, cache = model.decode_step(params, cache, toks[:, t], t)
            steps.append(lg)
    _close(last, logits[:, -1], tol=3e-3)
    _close(torch.stack(steps, 1), logits, tol=3e-3)
    assert abs(task.eval_fn(params)["loss"] - float(np.log(128))) < 0.5


@pytest.mark.parametrize("n,d", [(1, 262144000), (8, 45088768)])
def test_lm_leaf_quant_kernels_match_plain(cuda, n, d):
    """quantize_rows and dequantize_rows at yi-9b's full-width leaf views —
    the 64,000 × 4,096 embedding as one row, and an MLP leaf (4,096 ×
    11,008) by the 8 rows of the int8 cache — bit for bit with their plain
    versions."""
    g = torch.Generator(device=cuda).manual_seed(n)
    x = torch.randn(n, d, generator=g, device=cuda) * 0.02
    q1, s1 = ops.quantize_rows(x)
    q2, s2 = ops.quantize_rows(x, backend="torch")
    torch.cuda.synchronize()
    assert torch.equal(q1, q2) and torch.equal(s1, s2)
    del x, q2
    x1 = ops.dequantize_rows(q1, s1)
    x2 = ops.dequantize_rows(q1, s1, backend="torch")
    torch.cuda.synchronize()
    assert torch.equal(x1, x2)


# --- the rest of the real models: SSM, hybrid, MoE, encoder-decoder ---------

SSM_MOE_ARCHS = ["qwen3-moe-235b-a22b", "arctic-480b", "mamba2-780m",
                 "zamba2-1.2b", "seamless-m4t-medium"]


def _reduced_batch(cfg, device, B=2, L=64, seed=0):
    """tests/test_configs_smoke.py's batch (tokens and targets; source
    frames for the encoder-decoder)."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, L)),
             "targets": rng.integers(0, cfg.vocab_size, (B, L))}
    batch = {k: torch.as_tensor(v.astype(np.int32), device=device)
             for k, v in batch.items()}
    if cfg.frontend == "audio":
        batch["audio_embeds"] = torch.as_tensor(
            (rng.normal(size=(B, L // cfg.encoder_frames_ratio, cfg.d_model))
             * 0.1).astype(np.float32), device=device)
    return batch


def _forward_and_decode(model, params, batch, device, steps=8):
    """(logits, loss, [decode logits]) with `steps` decode steps from
    `init_cache`, each fed the batch's next token."""
    with torch.no_grad():
        logits, _ = model.forward(params, batch)
        loss = model.loss_fn(params, batch)
        B = batch["tokens"].shape[0]
        cache = model.init_cache(B, 64, device=device)
        outs = []
        for t in range(steps):
            lg, cache = model.decode_step(params, cache,
                                          batch["tokens"][:, t], t)
            outs.append(lg)
    return logits, loss, outs


@pytest.mark.parametrize("arch", SSM_MOE_ARCHS)
def test_ssm_moe_reduced_archs_match_cpu(cuda, arch):
    """The five archs of the second half of the real models (MoE, arctic's
    dense residual, Mamba-2, the zamba2 hybrid, the encoder-decoder) at
    their `reduced()` widths: forward logits, loss and 8 decode steps on
    the card within 1e-4 of the same model's CPU run (the weights drawn
    on the CPU and copied), all finite."""
    from repro_torch.configs.registry import get_config
    from repro_torch.convert import tree_map
    from repro_torch.models import build_model
    cfg = get_config(arch).reduced()
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    cpu = _forward_and_decode(model, params, _reduced_batch(cfg, "cpu"),
                              "cpu")
    card = _forward_and_decode(model, tree_map(lambda x: x.to(cuda), params),
                               _reduced_batch(cfg, cuda), cuda)
    assert bool(torch.isfinite(card[0]).all())
    _close(card[0], cpu[0], tol=1e-4)
    _close(card[1], cpu[1], tol=1e-4)
    for a, b in zip(card[2], cpu[2]):
        assert bool(torch.isfinite(a).all())
        _close(a, b, tol=1e-4)


def test_moe_gradients_bit_for_bit(cuda):
    """The reduced qwen3-moe's loss gradient (the router's aux term in it)
    twice on one batch: every leaf equal bit for bit — the MoE dispatch
    and combine sum nothing in an order the card picks (no atomics) —
    and at capacity factor 1.0, where tokens are dropped, too."""
    import dataclasses
    from repro_torch.configs.registry import get_config
    from repro_torch.convert import _rebuild, leaves
    from repro_torch.models import build_model
    base = get_config("qwen3-moe-235b-a22b").reduced()
    for cf in (base.capacity_factor, 1.0):
        cfg = dataclasses.replace(base, capacity_factor=cf)
        model = build_model(cfg)
        params = model.init(torch.Generator(device=cuda).manual_seed(0))
        batch = _reduced_batch(cfg, cuda)

        def grads():
            xs = [x.detach().requires_grad_(True) for x in leaves(params)]
            loss = model.loss_fn(_rebuild(params, iter(xs)), batch)
            return loss.detach(), torch.autograd.grad(loss, xs)
        l1, g1 = grads()
        l2, g2 = grads()
        assert torch.equal(l1, l2) and bool(torch.isfinite(l1))
        assert all(torch.equal(a, b) for a, b in zip(g1, g2))


@pytest.mark.parametrize("name,K", [("ace", 1), ("aced", 3)])
def test_ssm_hybrid_lm_tree_graph_run_matches_eager(cuda, name, K):
    """The reduced zamba2 (mamba ×5 and the shared attention block) on the
    LM task, tree layout, int8 cache and int8 history ring: the captured
    tick replays bit for bit like the eager tick, both quant kernels
    launched in the replays as often as eagerly."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core.fl_tasks import make_lm_task
    from repro_torch.convert import leaves
    cfg = get_config("zamba2-1.2b").reduced(layers=6, d_model=64, vocab=128)
    task = make_lm_task(cfg=cfg, n_clients=4, batch=2, seq=32,
                        n_tokens=1 << 14, seed=0, device=cuda)
    rand, noise = _streams(task.grad_fn, 4, K, 16, cuda)
    kw = dict(grad_fn=task.grad_fn, params0=task.params0, n_clients=4,
              T=16, beta=2.0, k_batch=K, layout="tree", history_dtype="int8",
              device=cuda)
    rule = (lambda: tagg.ACEIncremental(cache_dtype="int8")) if name == "ace" \
        else (lambda: tagg.ACED(tau_algo=5, cache_dtype="int8", max_cohort=K))
    graph = make_staleness_runner(aggregator=rule(), graph=True, **kw)
    eager = make_staleness_runner(aggregator=rule(), graph=False, **kw)
    graph(rand, noise, 0.05)
    ops.reset_launch_counts()
    replayed = graph(rand, noise, 0.05)
    replay_counts = ops.launch_counts()
    ops.reset_launch_counts()
    ref = eager(rand, noise, 0.05)
    assert ops.launch_counts() == replay_counts
    assert replay_counts["quantize_rows"] > 0
    assert replay_counts["dequantize_rows"] > 0
    assert graph.captures == 1
    _same_tree_result(replayed, ref)
    assert all(bool(torch.isfinite(x).all()) for x in leaves(ref[0]))


# --- the train stack (the AFL train step, checkpoints, the train driver) ---

def _train_steps(device, cache_dtype, algo="ace", backend=None, steps=4):
    """`steps` AFL train steps of the reduced yi LM loss on `device` from
    the same CPU-drawn weights and batches -> (params, rule state, launch
    counts)."""
    from repro_torch.configs.base import AFLConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.convert import tree_map
    from repro_torch.core.distributed import make_afl_train_step
    from repro_torch.models import build_model
    from repro_torch.optim import sgd
    model = build_model(get_config("yi-9b").reduced(layers=2, d_model=64,
                                                    vocab=128))
    params = tree_map(lambda x: x.to(device), model.init(
        torch.Generator().manual_seed(0), device="cpu"))
    cfg = AFLConfig(algorithm=algo, n_clients=4, tau_algo=3,
                    cache_dtype=cache_dtype)
    init_fn, step_fn = make_afl_train_step(model.loss_fn, cfg, sgd(0.1),
                                           backend=backend)
    state = init_fn(params)
    toks = torch.randint(0, 128, (steps, 2, 33), generator=torch.Generator(
        ).manual_seed(1), dtype=torch.int32).to(device)
    ops.reset_launch_counts()
    for s in range(steps):
        batch = {"tokens": toks[s, :, :-1], "targets": toks[s, :, 1:]}
        state, metrics = step_fn(state, batch, s % 4, s % 3)
        assert bool(torch.isfinite(metrics["loss"]))
    return state.params, state.afl, ops.launch_counts()


@pytest.mark.parametrize("algo,cache_dtype", [("ace", "int8"),
                                              ("aced", "float32")])
def test_train_step_on_the_card_matches_the_cpu(cuda, algo, cache_dtype):
    """The train step on the card against the same steps on the CPU (the
    plain versions there): parameters within 1e-4 of their scale, int8
    codes within one step; an int8 cache launches both quant kernels, and
    ``backend="torch"`` none."""
    from repro_torch.convert import leaves
    from repro_torch.core.cache import cache_tensors
    p_cpu, s_cpu, _ = _train_steps("cpu", cache_dtype, algo)
    p_gpu, s_gpu, counts = _train_steps(cuda, cache_dtype, algo)
    for a, b in zip(leaves(p_gpu), leaves(p_cpu)):
        _close(a, b, tol=1e-4)
    for a, b in zip(cache_tensors(s_gpu["cache"]),
                    cache_tensors(s_cpu["cache"])):
        if a.dtype == torch.int8:
            assert int((a.cpu().int() - b.int()).abs().max()) <= 1
        else:
            _close(a, b, tol=1e-4)
    if cache_dtype == "int8":
        assert counts["quantize_rows"] > 0 and counts["dequantize_rows"] > 0
        _, _, plain = _train_steps(cuda, cache_dtype, algo, backend="torch")
        assert sum(plain.values()) == 0


def test_train_checkpoint_restores_onto_cuda_tensors(cuda, tmp_path):
    """A chunked tree carry on the card (int8 cache and ring) saved and
    restored onto a fresh carry: every leaf on the card, of its dtype, bit
    for bit; a bf16 leaf too."""
    from repro_torch.checkpoint import (restore_checkpoint,
                                        restore_train_checkpoint,
                                        save_checkpoint,
                                        save_train_checkpoint)
    from repro_torch.checkpoint.checkpoint import _paths
    task = _lm_task(cuda)
    rand, noise = _streams(task.grad_fn, 4, 1, 12, cuda)
    runner = make_chunked_staleness_runner(
        capacity=12, grad_fn=task.grad_fn, params0=task.params0,
        aggregator=tagg.ACEIncremental(cache_dtype="int8"), n_clients=4,
        T=12, beta=2.0, layout="tree", history_dtype="int8", device=cuda)
    carry, _ = runner.chunk(runner.init(0.05, noise.init), rand, noise.ticks,
                            0.05)
    save_train_checkpoint(str(tmp_path), 12, carry)
    back, e = restore_train_checkpoint(str(tmp_path),
                                       runner.init(0.05, noise.init))
    assert e == 12 == int(back["e"])
    pairs = list(zip(_paths(back), _paths(carry)))
    assert len(pairs) > 30
    for (ka, a), (kb, b) in pairs:
        assert ka == kb and a.device.type == "cuda" and a.dtype == b.dtype
        assert torch.equal(a, b), ka
    h = torch.randn(5, 7, device=cuda).to(torch.bfloat16)
    save_checkpoint(str(tmp_path), 0, {"h": h}, prefix="bf")
    got = restore_checkpoint(str(tmp_path), 0, {"h": torch.zeros_like(h)},
                             prefix="bf")["h"]
    assert got.device.type == "cuda" and got.dtype == torch.bfloat16
    assert torch.equal(got.view(torch.int16), h.view(torch.int16))


def test_train_driver_resumes_bit_for_bit_on_the_card(cuda, tmp_path):
    """The train driver on the card (graph runner, int8 cache): a run
    resumed from its first checkpoint writes the straight run's final
    checkpoint bit for bit."""
    import os
    import shutil
    from repro_torch.launch.train import main as train_main
    args = ["--arch", "yi-9b", "--reduced", "--d-model", "64", "--layers",
            "2", "--vocab", "128", "--seq", "32", "--batch", "2",
            "--n-clients", "4", "--steps", "24", "--chunk-events", "8",
            "--ckpt-every", "8", "--cache-dtype", "int8", "--log-every",
            "50"]
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    train_main(args + ["--ckpt-dir", a])
    shutil.copytree(a, b)
    names = sorted(f for f in os.listdir(b) if f.endswith(".npz"))
    for f in names[1:]:
        os.remove(os.path.join(b, f))
        os.remove(os.path.join(b, f + ".sha256"))
    train_main(args + ["--ckpt-dir", b])
    with np.load(os.path.join(a, names[-1])) as x, \
            np.load(os.path.join(b, names[-1])) as y:
        assert sorted(x.files) == sorted(y.files)
        for k in x.files:
            assert np.array_equal(x[k], y[k]), k


def test_sharded_runner_world_one_nccl_matches_unsharded(cuda, tmp_path):
    """The sharded runner on an NCCL group of one rank ((1, 1) mesh, every
    block collective issued and captured in the tick's CUDA graph): int8
    ACE and ACED K = 1 and CA²FL K = 4 on the vision task end where the
    unsharded graph runs do, their kernels launched and the tick
    captured."""
    import torch.distributed as dist
    from repro_torch.core.scan_sharded import make_sharded_staleness_runner
    from repro_torch.launch.mesh import make_host_mesh
    torch.cuda.set_device(torch.cuda.current_device())
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    try:
        mesh = make_host_mesh()
        assert tuple(mesh.shape) == (1, 1)
        task = make_vision_task(n_clients=16, alpha=0.3, batch=8,
                                n_classes=10, dim=32, hidden=(64,),
                                n_train=800, n_test=100, seed=0,
                                device=cuda)
        for name, K, kernel in (("ace", 1, "cache_row_update"),
                                ("aced", 1, "row_delta"),
                                ("ca2fl", 4, "commit_batch")):
            def rule():
                if name == "ace":
                    return tagg.ACEIncremental(cache_dtype="int8")
                if name == "aced":
                    return tagg.ACED(tau_algo=5, cache_dtype="int8")
                return tagg.CA2FL(buffer_size=4, cache_dtype="int8")
            kw = dict(grad_fn=task.grad_fn, params0=task.params0,
                      n_clients=16, T=40, beta=2.0, k_batch=K, device=cuda)
            E = default_n_events(rule(), 40)
            rand = build_staleness_randomness(1, E, 16, 2.0, k_batch=K,
                                              device=cuda)
            noise = build_payload_noise(task.grad_fn, 1, E, 16, K, 1, cuda)
            plain = make_staleness_runner(aggregator=rule(), **kw)
            w0 = plain(rand, noise, 0.05)[0]
            sharded = make_sharded_staleness_runner(mesh=mesh,
                                                    aggregator=rule(), **kw)
            ops.reset_launch_counts()
            w1 = sharded(rand, noise, 0.05)[0]
            counts = ops.launch_counts()
            assert sharded.captures >= 1
            assert counts[kernel] > 0
            assert float((w1 - w0).abs().max()) <= 1e-5
    finally:
        dist.destroy_process_group()
