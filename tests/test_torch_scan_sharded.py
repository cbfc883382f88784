"""The port's sharded staleness runner (`repro_torch.core.scan_sharded`) on
four CPU ``gloo`` ranks that this file starts itself, held three ways:
against the port's unsharded run and against the JAX package's unsharded
run, all fed the same JAX-drawn streams (`randomness=`, `payload_noise=`,
`faults=`) and the same weights (`repro_torch.convert`).

The cases are JAX's sharded suite (tests/test_scan_sharded.py): seven
rules, dropout, speed skew, availability windows (freeze and thaw), int8
caches, incremental against direct, shapes that do not divide, seeds, the
lr × seed grid and the MLP task; tests/test_k_batch.py's K = 4 cases,
tests/test_faults.py's faulted stream (guards, resync and the checks on),
tests/test_train_scan.py's tree layout (the vision MLP), the chunked
runner, and the train driver on two ranks against one process. Each runs
on the ``("data", "model")`` meshes (2, 2), (4, 1) and (1, 4) of one
4-rank group. What is compared is JAX's `_assert_matches`: `w` within
1e-5, `ts`, `total_comms`, `eval_ts` (and the guard counters) exact,
losses and update norms within rtol 1e-4. After a run each rank must hold
only its block of the cache ``(n/data, d/model)``, of the ring and of the
snapshots ``(·, d/model)``, a dim that does not divide its axis whole.

How it runs: a module fixture draws every case's streams with JAX, starts
the ranks (spawned: they never import JAX, nor does this module at its top
level), computes the unsharded references while they run, and joins them
within `DEADLINE` seconds, killing them past it. Each rank runs every case
on every mesh and writes its results to a file the fixture reads.
"""
import functools
import os
import pickle
import time
import traceback
from datetime import timedelta

import numpy as np
import pytest

torch = pytest.importorskip("torch")

torch.set_num_threads(1)

WORLD = 4
MESHES = {"2x2": (2, 2), "4x1": (4, 1), "1x4": (1, 4)}
#: seconds the ranks get in all; a collective that hangs raises after the
#: group's own 60 s
DEADLINE = 240
N, D, SIGMA, ZETA = 8, 8, 0.2, 2.0

RULES = {"asgd": ("VanillaASGD", {}),
         "fedbuff": ("FedBuff", {"buffer_size": 4}),
         "ca2fl": ("CA2FL", {"buffer_size": 4}),
         "ca2fl_direct": ("CA2FLDirect", {"buffer_size": 4}),
         "ace": ("ACEIncremental", {}),
         "aced": ("ACED", {"tau_algo": 5}),
         "aced_direct": ("ACEDDirect", {"tau_algo": 5})}
SEVEN = sorted(RULES)
#: every client leaves at 12 and comes back at 22, client 3 at 30
WINDOWS = (np.full(N, 12, np.int32),
           np.where(np.arange(N) == 3, 30, 22).astype(np.int32))
FAULT_RATES = dict(nan_rate=0.08, explode_rate=0.05, byzantine_rate=0.05,
                   overstale_rate=0.05)
VISION = dict(n_clients=8, alpha=0.3, batch=6, n_classes=10, dim=8,
              hidden=(16, 8), n_train=400, n_test=100, seed=0)


def _case(rule, **kw):
    c = dict(rule=rule, over={}, task="quad", n=N, d=D, T=30, beta=2.0,
             seed=0, lr=0.05, K=1, windows=False, dropout=None, skew=0.0,
             eval_every=None, faults=False, clip=0.0, resync=None,
             checks=None, layout="flat", kind="run")
    c.update(kw)
    return c


CASES = {}
for _r in SEVEN:
    CASES[f"base-{_r}"] = _case(_r)
    CASES[f"windows-{_r}"] = _case(_r, T=40, windows=True, eval_every=10)
for _r in ("aced", "fedbuff", "asgd"):
    CASES[f"dropout-{_r}"] = _case(_r, T=40, dropout=(0.5, 20))
for _r in ("ace", "ca2fl"):
    CASES[f"skew-{_r}"] = _case(_r, skew=2.0)
for _r in ("ace", "aced", "aced_direct", "ca2fl", "ca2fl_direct"):
    CASES[f"int8-{_r}"] = _case(_r, T=30, over={"cache_dtype": "int8"})
for _r in ("aced", "aced_direct", "ca2fl", "ca2fl_direct"):
    CASES[f"windows-int8-{_r}"] = _case(_r, T=40, windows=True,
                                        over={"cache_dtype": "int8"})
CASES["nondividing-ace"] = _case("ace", n=7, d=5, T=30)
for _r, _o in (("ace", {"cache_dtype": "int8"}), ("aced", {"max_cohort": 4}),
               ("ca2fl", {"cache_dtype": "int8"})):
    CASES[f"k4-{_r}"] = _case(_r, T=30, K=4, over=_o)
CASES["faults-aced"] = _case("aced", T=30, faults=True, clip=5.0, resync=5,
                             checks=True)
CASES["mlp-ace"] = _case("ace", task="mlp", T=25)
for _r in ("ace", "aced", "ca2fl"):
    CASES[f"tree-{_r}"] = _case(_r, task="mlp", T=16, layout="tree")
CASES["seeds-ace"] = _case("ace", T=20, kind="seeds", seeds=(1, 2, 3))
CASES["grid-fedbuff"] = _case("fedbuff", T=20, kind="grid", seeds=(1, 2),
                              lrs=(0.02, 0.1), over={"buffer_size": 3})
CASES["chunked-ace-int8"] = _case("ace", T=30, kind="chunked", capacity=7,
                                  over={"cache_dtype": "int8"})
#: the runner cases whose carry is read after the run (blocks' shapes)
LAYOUT_CASES = {"layout-ace-int8": _case("ace", T=20, eval_every=10,
                                         over={"cache_dtype": "int8"}),
                "layout-ca2fl": _case("ca2fl", T=20, eval_every=10),
                "layout-nondividing": _case("ace", n=7, d=5, T=20,
                                            eval_every=10)}
TRAIN = ["--arch", "yi-9b", "--reduced", "--d-model", "64", "--layers", "2",
         "--vocab", "128", "--seq", "32", "--batch", "2", "--algo", "aced",
         "--n-clients", "4", "--ckpt-every", "10", "--log-every", "50",
         "--device", "cpu"]


# ---------------------------------------------------------------------------
# The port's side: what a rank (and the unsharded reference) runs.
# ---------------------------------------------------------------------------

def _rule(mod, case):
    cls, kw = RULES[case["rule"]]
    return getattr(mod, cls)(**{**kw, **case["over"]})


def _quad_centers(n, d):
    rng = np.random.default_rng(0)
    return (rng.normal(size=(n, d)) * ZETA).astype(np.float32)


def _torch_task(case, params0):
    """(grad_fn, params0, eval_fn) of the port."""
    from repro_torch import convert
    from repro_torch.core import fl_tasks as ttasks
    if case["task"] == "quad":
        C = torch.as_tensor(_quad_centers(case["n"], case["d"]))

        def g(w, clients, noise):
            diff = w - C[clients]
            return 0.5 * (diff ** 2).sum(-1), diff + SIGMA * noise
        return (ttasks.ClientGrad(g, (case["d"],), "normal"),
                torch.zeros(case["d"]),
                lambda p: {"dist": float(torch.linalg.vector_norm(p))})
    task = ttasks.make_vision_task(**VISION, device="cpu")
    return task.grad_fn, convert.params_from_jax(params0), None


def _streams(inp):
    """The case's JAX-drawn streams as the port's objects."""
    from repro_torch.core.scan_engine import PayloadNoise
    from repro_torch.core.scan_staleness import (FaultSchedule,
                                                 StalenessRandomness)
    t = lambda x: torch.as_tensor(np.array(x))  # noqa: E731
    rand = StalenessRandomness(*map(t, inp["rand"]))
    noise = PayloadNoise(*map(t, inp["noise"]))
    faults = FaultSchedule(*map(t, inp["faults"])) if inp["faults"] else None
    return rand, noise, faults


def _summary(r):
    return dict(w=np.asarray(r.w, np.float32), ts=[int(x) for x in r.ts],
                comms=int(r.total_comms), losses=np.asarray(r.losses),
                norms=np.asarray(r.update_norms), evals=list(r.evals),
                eval_ts=list(r.eval_ts), faults=dict(r.faults))


def _port_run(case, inp, mesh=None):
    """The port's run of `case` on its streams (sharded with `mesh`) ->
    a summary, or a list of them (seeds, grid)."""
    from repro_torch.core import aggregators as tagg
    from repro_torch.core.scan_staleness import (make_chunked_staleness_runner,
                                                 run_staleness_grid,
                                                 run_staleness_scan,
                                                 run_staleness_seeds)
    grad_fn, params0, eval_fn = _torch_task(case, inp["params0"])
    common = dict(grad_fn=grad_fn, params0=params0, n_clients=case["n"],
                  T=case["T"], beta=case["beta"], device="cpu", mesh=mesh)
    if case["kind"] in ("seeds", "grid"):
        streams = [_streams(s) for s in inp["per_seed"]]
        kw = dict(common, aggregator=_rule(tagg, case), seeds=case["seeds"],
                  randomness=[s[0] for s in streams],
                  payload_noise=[s[1] for s in streams])
        if case["kind"] == "seeds":
            return [_summary(r) for r in run_staleness_seeds(
                server_lr=case["lr"], **kw)]
        return [[_summary(r) for r in row] for row in run_staleness_grid(
            lrs=case["lrs"], **kw)]
    rand, noise, faults = _streams(inp)
    if case["kind"] == "chunked":
        kw = dict(common)
        del kw["mesh"]
        if mesh is not None:
            from repro_torch.core.scan_sharded import (
                make_sharded_chunked_staleness_runner as make)
            runner = make(mesh=mesh, capacity=case["capacity"],
                          aggregator=_rule(tagg, case), **kw)
        else:
            runner = make_chunked_staleness_runner(
                capacity=case["capacity"], aggregator=_rule(tagg, case), **kw)
        carry = runner.init(case["lr"], noise.init)
        emit, loss = [], []
        for a in range(0, rand.n_events, case["capacity"]):
            b = min(a + case["capacity"], rand.n_events)
            carry, outs = runner.chunk(carry, rand.slice(a, b),
                                       noise.ticks[a:b], case["lr"])
            emit.append(outs["emit"].numpy())
            loss.append(outs["loss"].numpy())
        emit = np.concatenate(emit)
        return dict(w=carry["w"].numpy().copy(), emit=emit,
                    losses=np.concatenate(loss)[emit])
    return _summary(run_staleness_scan(
        aggregator=_rule(tagg, case), server_lr=case["lr"],
        speed_skew=case["skew"], eval_fn=eval_fn,
        eval_every=case["eval_every"], faults=faults, clip_norm=case["clip"],
        resync_every=case["resync"], checkify_invariants=case["checks"],
        k_batch=case["K"], layout=case["layout"], randomness=rand,
        payload_noise=noise, **common))


def _layout_run(case, inp, mesh):
    """A sharded runner's call beside the unsharded runner's, then the
    shapes of the blocks its carry holds after the run's ticks -> (how far
    the sharded run's model, snapshots, whole cache (`gather_full`) and
    ring lie from the unsharded run's; the shapes)."""
    from repro_torch.core import aggregators as tagg
    from repro_torch.core.scan_sharded import make_sharded_staleness_runner
    from repro_torch.core.scan_staleness import (eval_marks_for,
                                                 make_staleness_runner)
    grad_fn, params0, _ = _torch_task(case, inp["params0"])
    rand, noise, _ = _streams(inp)
    kw = dict(grad_fn=grad_fn, params0=params0, n_clients=case["n"],
              T=case["T"], beta=case["beta"], eval_marks=eval_marks_for(
                  case["T"], case["eval_every"]), device="cpu")
    runner = make_sharded_staleness_runner(mesh=mesh,
                                           aggregator=_rule(tagg, case), **kw)
    plain = make_staleness_runner(aggregator=_rule(tagg, case), **kw)
    w, _, _, extras = runner(rand, noise, case["lr"])
    pw, _, _, pextras = plain(rand, noise, case["lr"])
    key = "cache" if "cache" in runner.carry["state"] else "h"
    cache, pcache = runner.carry["state"][key], plain.carry["state"][key]
    ring, pring = runner.carry["ring"], plain.carry["ring"]["q"]
    dist = lambda a, b: float((a - b).abs().max())  # noqa: E731
    return (dict(w=dist(w, pw), snaps=dist(extras["snaps"], pextras["snaps"]),
                 cache=dist(cache.gather_full(), pcache.dequant()),
                 ring=dist(ring.gather_full(), pring),
                 snaps_full=tuple(extras["snaps"].shape)),
            dict(cache=tuple(cache.data.shape), scale=tuple(cache.scale.shape),
                 ring=tuple(ring.data.shape),
                 snaps=tuple(runner.carry["snaps"].shape)))


def _mesh_checks(tmp):
    """The helpers' contract on the 4-rank world -> {name: ok}."""
    from repro_torch.core.scan_sharded import (
        make_sharded_chunked_staleness_runner, make_sharded_staleness_runner,
        staleness_mesh)
    from repro_torch.checkpoint import save_train_checkpoint
    from repro_torch.core.cache import init_flat_cache
    mesh = staleness_mesh()
    out = {"auto": tuple(mesh.shape) == (2, 2),
           "model4": tuple(staleness_mesh(model=4).shape) == (1, 4),
           "names": mesh.mesh_dim_names == ("data", "model")}
    block = init_flat_cache(8, 8, "int8", device="cpu", mesh=mesh)
    try:
        save_train_checkpoint(f"{tmp}/blocked-{block.block.r0}-"
                              f"{block.block.f0}", 0, {"cache": block})
        out["checkpoint"] = False
    except NotImplementedError:
        out["checkpoint"] = True
    for name, fn in (("model3", lambda: staleness_mesh(model=3)),
                     ("runner", lambda: make_sharded_staleness_runner(
                         mesh=None, grad_fn=None, params0=None,
                         aggregator=None, n_clients=1, T=1, beta=1.0)),
                     ("chunked", lambda: make_sharded_chunked_staleness_runner(
                         mesh=None, capacity=1))):
        try:
            fn()
            out[name] = False
        except ValueError:
            out[name] = True
    return out


def _train(argv, rank_dir=None):
    """The train driver's final loss, and how many checkpoints this process
    wrote."""
    from repro_torch.launch import train as ttrain
    saves = []
    real = ttrain.save_train_checkpoint

    def counting(*a, **k):
        saves.append(a[1])
        return real(*a, **k)
    ttrain.save_train_checkpoint = counting
    try:
        return ttrain.main(argv), saves
    finally:
        ttrain.save_train_checkpoint = real


class _Inputs(dict):
    """The cases' inputs as the parent writes them into `tmp`, one file a
    case, read the first time a case is asked for (waiting for its
    file)."""

    def __init__(self, tmp):
        super().__init__()
        self.tmp = tmp

    def __missing__(self, name):
        path = f"{self.tmp}/in-{name}.pkl"
        while not os.path.exists(path):
            time.sleep(0.05)
        with open(path, "rb") as f:
            self[name] = pickle.load(f)
        return self[name]


def _rank_main(rank, tmp):
    """One rank: every case on every mesh, then (ranks 0 and 1) the train
    driver on a 2-rank group; results or the traceback into `tmp`."""
    import torch.distributed as dist
    import warnings
    warnings.filterwarnings("ignore")
    torch.set_num_threads(1)
    out = {}
    try:
        inputs = _Inputs(tmp)
        dist.init_process_group(
            "gloo", init_method=f"file://{tmp}/pg4", rank=rank,
            world_size=WORLD, timeout=timedelta(seconds=60))
        from repro_torch.sharding.rules import build_mesh
        out["mesh_checks"] = _mesh_checks(tmp)
        for mname, shape in MESHES.items():
            mesh = build_mesh(shape, ("data", "model"))
            for name, case in CASES.items():
                out[mname, name] = _port_run(case, inputs[name], mesh)
            for name, case in LAYOUT_CASES.items():
                out[mname, name] = _layout_run(case, inputs[name], mesh)
        dist.destroy_process_group()
        if rank < 2:
            dist.init_process_group(
                "gloo", init_method=f"file://{tmp}/pg2", rank=rank,
                world_size=2, timeout=timedelta(seconds=60))
            ck = f"{tmp}/train_ckpt"
            first = _train(TRAIN + ["--steps", "10", "--ckpt-dir", ck])
            second = _train(TRAIN + ["--steps", "20", "--ckpt-dir", ck])
            out["train"] = (second[0], len(first[1]) + len(second[1]))
            dist.destroy_process_group()
        with open(f"{tmp}/rank{rank}.pkl", "wb") as f:
            pickle.dump(out, f)
    except BaseException:
        with open(f"{tmp}/rank{rank}.err", "w") as f:
            f.write(traceback.format_exc())
        raise


# ---------------------------------------------------------------------------
# The parent's side: JAX's streams and runs.
# ---------------------------------------------------------------------------

def _jax_task(case):
    """(grad_fn, params0, noise_of, noise shape, eval_fn) of JAX: one
    object per task, so that JAX compiles each of its functions once."""
    return _jax_task_of(case["task"], case["n"], case["d"])


@functools.lru_cache(maxsize=None)
def _jax_task_of(task, n, d):
    import jax
    import jax.numpy as jnp
    if task == "quad":
        C = jnp.asarray(_quad_centers(n, d))

        def grad_fn(params, client, key):
            g = params - C[client] + SIGMA * jax.random.normal(key, (d,))
            return 0.5 * jnp.sum((params - C[client]) ** 2), g
        return (grad_fn, jnp.zeros(d), lambda key: jax.random.normal(key,
                                                                     (d,)),
                (d,), lambda p: {"dist": float(jnp.sqrt(jnp.sum(p ** 2)))})
    from repro.core import fl_tasks as jtasks
    from test_torch_engine import jax_vision_grad
    jgrad, noise_of = jax_vision_grad(VISION)
    return (jgrad, jtasks.make_vision_task(**VISION).params0, noise_of,
            (VISION["batch"],), None)


def _n_events(case, jagg):
    from repro.core.scan_engine import default_n_events
    n = default_n_events(_rule(jagg, case), case["T"])
    if case["windows"]:
        n += case["n"]
    if case["faults"]:
        n += 60
    return n


@functools.lru_cache(maxsize=None)
def _jitted(noise_of):
    import jax
    return (jax.jit(jax.random.split, static_argnums=1),
            jax.jit(jax.vmap(noise_of)))


#: the noise draws are padded to a multiple of this many keys, so JAX
#: compiles each task's draw once
KEY_BLOCK = 1024


def _payload_noise(seed, E, n, K, noise_of, shape, wants_init):
    """The payload noise JAX's key chain hands to each client call of a
    run with `seed` (`test_torch_engine.replay_streams` at one local step:
    one split a call for the init batch and K = 1 ticks, ``split(key,
    K+1)`` then one split a lane for K > 1) -> (init (n, 1, ...), ticks
    (E, K, 1, ...))."""
    import jax
    import jax.numpy as jnp
    split, draw = _jitted(noise_of)
    key, subs = jax.random.PRNGKey(seed), []
    for _ in range(n if wants_init else 0):
        key, sub = split(key, 2)
        subs.append(sub)
    for _ in range(E):
        if K == 1:
            key, sub = split(key, 2)
            subs.append(sub)
        else:
            keys = split(key, K + 1)
            key = keys[0]
            subs += [split(k, 2)[1] for k in keys[1:]]
    keys = jnp.stack(subs)
    pad = -len(subs) % KEY_BLOCK
    keys = jnp.concatenate([keys, jnp.zeros((pad, 2), keys.dtype)])
    vals = np.asarray(draw(keys))[:len(subs)]
    m = n if wants_init else 0
    init = (vals[:m].reshape((n, 1) + shape) if wants_init
            else np.zeros((n, 1) + shape, np.float32))
    return init, vals[m:].reshape((E, K, 1) + shape)


def _jax_streams(case, seed, jagg):
    """The JAX engine's streams for `seed` as numpy arrays."""
    from repro.core.scan_staleness import (build_fault_schedule,
                                           build_staleness_randomness)
    _, _, noise_of, shape, _ = _jax_task(case)
    E = _n_events(case, jagg)
    drop = case["dropout"] or (0.0, None)
    windows = WINDOWS if case["windows"] else None
    r = build_staleness_randomness(seed, E, case["n"], case["beta"], drop[0],
                                   case["skew"], dropout_at=drop[1],
                                   windows=windows, k_batch=case["K"])
    out = {"rand": [np.asarray(x) for x in (r.gumbels, r.tau_raw, r.leave_at,
                                            r.rejoin_at)],
           "noise": list(_payload_noise(
               seed, E, case["n"], case["K"], noise_of, shape,
               jagg.wants_cache_init(_rule(jagg, case)))),
           "faults": None}
    if case["faults"]:
        fa = build_fault_schedule(seed, E, **FAULT_RATES)
        out["faults"] = [np.asarray(fa.kind), np.asarray(fa.scale)]
    return out


def _inputs(case):
    import jax
    from repro.core import aggregators as jagg
    _, params0, _, _, _ = _jax_task(case)
    if case["kind"] in ("seeds", "grid"):
        inp = {"per_seed": [_jax_streams(case, s, jagg)
                            for s in case["seeds"]]}
    else:
        inp = _jax_streams(case, case["seed"], jagg)
    inp["params0"] = jax.tree.map(np.asarray, params0)
    return inp


def _jax_run(case):
    """JAX's unsharded run of `case` (it draws the streams from the seed
    itself) -> summaries as `_port_run` gives them."""
    from repro.core import aggregators as jagg
    from repro.core.scan_staleness import (build_fault_schedule,
                                           run_staleness_grid,
                                           run_staleness_scan,
                                           run_staleness_seeds)
    grad_fn, params0, _, _, eval_fn = _jax_task(case)
    E = _n_events(case, jagg)
    common = dict(grad_fn=grad_fn, params0=params0, n_clients=case["n"],
                  T=case["T"], beta=case["beta"], n_events=E)
    if case["kind"] == "seeds":
        return [_summary(r) for r in run_staleness_seeds(
            aggregator=_rule(jagg, case), server_lr=case["lr"],
            seeds=list(case["seeds"]), **common)]
    if case["kind"] == "grid":
        return [[_summary(r) for r in row] for row in run_staleness_grid(
            aggregator=_rule(jagg, case), lrs=list(case["lrs"]),
            seeds=list(case["seeds"]), **common)]
    drop = case["dropout"] or (0.0, None)
    faults = (build_fault_schedule(case["seed"], E, **FAULT_RATES)
              if case["faults"] else None)
    return _summary(run_staleness_scan(
        aggregator=_rule(jagg, case), server_lr=case["lr"],
        speed_skew=case["skew"], dropout_frac=drop[0], dropout_at=drop[1],
        windows=WINDOWS if case["windows"] else None,
        eval_fn=eval_fn, eval_every=case["eval_every"], seed=case["seed"],
        faults=faults, clip_norm=case["clip"], resync_every=case["resync"],
        k_batch=case["K"], layout=case["layout"], **common))


def _join(procs, tmp, t0):
    """Wait for the ranks until `DEADLINE`; a rank that fails or a rank
    still running past it ends them all."""
    while True:
        codes = [p.exitcode for p in procs]
        bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
        late = time.time() - t0 > DEADLINE
        if bad or late or all(c == 0 for c in codes):
            break
        time.sleep(0.2)
    for p in procs:
        if p.is_alive():
            p.kill()
        p.join(5)
    if bad or late:
        errs = [open(f"{tmp}/rank{r}.err").read()
                for r in range(WORLD) if os.path.exists(f"{tmp}/rank{r}.err")]
        pytest.fail(("ranks past the deadline" if late else
                     f"ranks {bad} failed") + "\n" + "\n".join(errs[:1]))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{"ranks": [each rank's results], "port": unsharded, "jax": JAX's,
    "one": the chunked case run whole, "train": the one-process driver's
    final loss}."""
    import multiprocessing
    import sys
    # the ranks import this module by name
    sys.path.insert(0, os.path.dirname(__file__))
    tmp = str(tmp_path_factory.mktemp("sharded"))
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(r, tmp), daemon=True)
             for r in range(WORLD)]
    t0 = time.time()
    for p in procs:
        p.start()
    try:
        # each case's inputs as soon as they are drawn (the ranks wait for
        # them), then the references, while the ranks run
        inputs = {}
        for name, case in {**CASES, **LAYOUT_CASES}.items():
            inputs[name] = _inputs(case)
            with open(f"{tmp}/in-{name}.tmp", "wb") as f:
                pickle.dump(inputs[name], f)
            os.replace(f"{tmp}/in-{name}.tmp", f"{tmp}/in-{name}.pkl")
        port = {name: _port_run(case, inputs[name])
                for name, case in CASES.items()}
        jax_ref = {name: _jax_run(case) for name, case in CASES.items()
                   if case["kind"] != "chunked"}
        one = {name: _port_run(dict(case, kind="run"), inputs[name])
               for name, case in CASES.items() if case["kind"] == "chunked"}
        ck = f"{tmp}/train_one"
        _train(TRAIN + ["--steps", "10", "--ckpt-dir", ck])
        train_one = _train(TRAIN + ["--steps", "20", "--ckpt-dir", ck])[0]
    except BaseException:
        for p in procs:
            p.kill()
        raise
    _join(procs, tmp, t0)
    ranks = []
    for r in range(WORLD):
        with open(f"{tmp}/rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return {"ranks": ranks, "port": port, "jax": jax_ref, "one": one,
            "train": train_one}


def _assert_matches(b, a):
    """Summary `b` against `a`, as JAX's `_assert_matches`."""
    np.testing.assert_allclose(b["w"], a["w"], rtol=1e-5, atol=1e-5)
    assert b["ts"] == a["ts"]
    assert b["comms"] == a["comms"]
    np.testing.assert_allclose(b["losses"], a["losses"], rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(b["norms"], a["norms"], rtol=1e-4, atol=1e-5)
    assert b["eval_ts"] == a["eval_ts"]
    for be, ae in zip(b["evals"], a["evals"]):
        for k in ae:
            np.testing.assert_allclose(be[k], ae[k], rtol=1e-4, atol=1e-5)
    assert b["faults"] == a["faults"]


def _each(res, fn):
    """`fn(sharded, unsharded, jax)` over a case's summaries (each seed
    and grid cell)."""
    s, p, j = res
    if isinstance(s, list):
        for x in zip(s, p, j):
            _each(x, fn)
        return
    fn(s, p, j)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("name", sorted(n for n, c in CASES.items()
                                        if c["kind"] != "chunked"))
def test_sharded_run_matches_unsharded_and_jax(name, mesh, runs):
    """Every rank's sharded run == the port's unsharded run == JAX's."""
    def check(s, p, j):
        _assert_matches(s, p)
        _assert_matches(s, j)
        assert np.max(np.abs(s["w"] - j["w"])) <= 1e-5
    for rank in runs["ranks"]:
        _each((rank[mesh, name], runs["port"][name], runs["jax"][name]),
              check)
    if name.startswith("windows"):
        # the windows froze the run and the thaw jumped t
        ts = runs["port"][name]["ts"]
        assert not [t for t in ts if 12 < t < 22]


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("rule", ["aced", "ca2fl"])
@pytest.mark.parametrize("dtype", ["", "int8-"])
def test_sharded_incremental_matches_direct(dtype, rule, mesh, runs):
    """On the mesh the O(d) running sums reproduce the direct O(n·d)
    re-reduction's trajectory, across a freeze and a thaw."""
    for rank in runs["ranks"]:
        inc = rank[mesh, f"windows-{dtype}{rule}"]
        dr = rank[mesh, f"windows-{dtype}{rule}_direct"]
        assert inc["ts"] == dr["ts"]
        np.testing.assert_allclose(inc["w"], dr["w"], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(inc["norms"], dr["norms"], rtol=1e-4,
                                   atol=1e-5)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_sharded_chunked_runner_matches_one_run(mesh, runs):
    """The sharded chunked runner (chunks of 7 events, a partial tail) ends
    where one unsharded run does, and its chunks equal the unsharded
    chunks."""
    for rank in runs["ranks"]:
        s = rank[mesh, "chunked-ace-int8"]
        p = runs["port"]["chunked-ace-int8"]
        one = runs["one"]["chunked-ace-int8"]
        assert np.array_equal(s["emit"], p["emit"])
        np.testing.assert_allclose(s["w"], p["w"], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(s["w"], one["w"], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(s["losses"], one["losses"], rtol=1e-4,
                                   atol=1e-5)


def _block(n, d, shape):
    dd, dm = shape
    return (n // dd if n % dd == 0 else n, d // dm if d % dm == 0 else d)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("name", sorted(LAYOUT_CASES))
def test_rows_actually_sharded_after_the_run(name, mesh, runs):
    """After T ticks each rank holds only its block: the cache (n/data,
    d/model) with its scales, the ring (S, d/model), the snapshots
    (n_marks, d/model), a dim that does not divide its axis whole; the
    blocks put together (`gather_full`), the model and the whole snapshots
    it returns are the unsharded run's within 1e-5."""
    case = LAYOUT_CASES[name]
    n, d = case["n"], case["d"]
    rows, feats = _block(n, d, MESHES[mesh])
    for rank in runs["ranks"]:
        res, shapes = rank[mesh, name]
        for k in ("w", "snaps", "cache", "ring"):
            assert res[k] <= 1e-5, (k, res[k])
        assert shapes["cache"] == (rows, feats)
        assert shapes["scale"] == (rows,)
        assert shapes["ring"][1] == feats and shapes["snaps"][1] == feats
        assert res["snaps_full"] == (shapes["snaps"][0], d)
        if name != "layout-nondividing":
            assert (rows, feats) != (n, d) or MESHES[mesh] == (1, 1)
    if name == "layout-nondividing":
        assert (rows, feats) == (n, d)


def test_staleness_mesh_helper(runs):
    """`staleness_mesh` on four ranks: (2, 2) by default, (1, 4) with
    model=4, model=3 raises; the sharded runners raise without a mesh; a
    blocked cache refuses to be checkpointed (it is one rank's block)."""
    for rank in runs["ranks"]:
        assert all(rank["mesh_checks"].values()), rank["mesh_checks"]


def test_train_driver_on_two_ranks_matches_one_process(runs):
    """``--mesh auto`` on two gloo ranks (the sharded chunked runner, the
    tree layout replicated), run to 10 steps and resumed to 20 from the
    same checkpoint directory: both ranks end within 1e-5 of one process
    doing the same, and only rank 0 writes checkpoints."""
    (l0, saves0), (l1, saves1) = (runs["ranks"][r]["train"] for r in (0, 1))
    assert abs(l0 - runs["train"]) <= 1e-5 and abs(l1 - runs["train"]) <= 1e-5
    assert saves0 > 0 and saves1 == 0
