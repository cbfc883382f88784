"""The port's model, AFL train step, prefill and decode laid out by JAX's
specs (`repro_torch.sharding.place`: DTensors, TP over ``model``, FSDP over
``data``) on four CPU ``gloo`` ranks that this file starts itself, held
against the JAX package's own unsharded functions on the same weights and
inputs.

Three reduced f32 configs (d_model 64, vocab 128), each on the ``("data", "model")`` meshes (2, 2),
(4, 1) and (1, 4) of one 4-rank group: yi-9b (GQA, 8 heads over 4 kv
heads), gemma2-2b (attention and logit softcaps, a local window; 8 heads
over 2 kv heads, so on (1, 4) the kv heads do not divide the model split
and are gathered) and minicpm3-4b (MLA, the latent decode cache).

  (a) `make_afl_train_step`, two steps in a row, for ACE with an f32 tree
      cache, ACE int8 and ACED int8: the new parameters (`full_tree`) within
      1e-5 of JAX's, loss, grad_norm and update_norm within rtol 1e-4; the
      cache's int8 codes equal to JAX's or one code step from them at most
      once in 10^4 (ROADMAP C11: a summation order moved an element across
      a rounding boundary), its scales within 1e-5 relative (a scale is
      max|g| / 127, and the placed gradient's own f32 sums run in another
      order: up to 1.2e-6 apart here), and where a code moved, the
      parameter within 1e-5 plus the step's share of that code
      (lr · scale / n);
  (b) `prefill`: the last position's logits within 1e-5;
  (c) four `decode_step`s from an empty cache at B = 4 (batch over
      ``data``) and B = 1 (the sequence over ``data``): logits within 1e-5
      at each step and the argmax tokens equal;
  (d) each rank's local shapes of parameters, optimizer and AFL state and
      batch (before and after the steps) and of the decode cache (before
      and after each step) equal the specs' division of the global shapes:
      parameters, batches and caches DTensors, the state's leaves its
      specs split DTensors and the rest whole plain tensors;
  (e) the MoE FFN, the SSD, zamba2's shared block, the encoder-decoder and
      a checkpoint of a placed state: tests/test_torch_model_sharded_more.py.

How it runs, as tests/test_torch_scan_sharded.py does: the ranks are
spawned and never import JAX; the parent draws the weights with JAX and
hands them over in a pickle, computes JAX's references while the ranks run
and joins them, killing them after `STALL` seconds without a finished case
or `DEADLINE` seconds in all.
"""
import dataclasses
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
STALL, DEADLINE = 150, 900
#: arch -> (layers, the reduced config's fields that differ from
#: `reduced()`'s): two repeats of yi's layer, one unit of gemma2's (local,
#: global) pair, one MLA layer
ARCHS = {"yi-9b": (2, dict(num_heads=8, num_kv_heads=4)),
         "gemma2-2b": (2, dict(num_heads=8, num_kv_heads=2, window_size=8)),
         "minicpm3-4b": (1, dict(num_heads=8, num_kv_heads=8))}
#: (algorithm, cache dtype) of the train steps
RULES = (("ace", "float32"), ("ace", "int8"), ("aced", "int8"))
N_CLIENTS, LR, TAU = 4, 0.1, 3
CLIENTS, STALENESS = (0, 1), (1, 2)
B, L, MAX_LEN, DECODE_STEPS = 4, 16, 16, 4


def _jax_cfg(arch):
    from repro.configs.registry import get_config
    layers, over = ARCHS[arch]
    cfg = get_config(arch).reduced(layers=layers, d_model=64, vocab=128)
    return dataclasses.replace(cfg, dtype="float32", **over)


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(
        0, vocab, size=shape).astype(np.int32)


def _train_batches(vocab):
    toks = _tokens(1, (len(CLIENTS), B, L + 1), vocab)
    return [{"tokens": t[:, :-1], "targets": t[:, 1:]} for t in toks]


# ---------------------------------------------------------------------------
# The port's side: what a rank runs.
# ---------------------------------------------------------------------------

def _split_shape(shape, spec, sizes):
    out = list(shape)
    for d, s in enumerate(spec or ()):
        for a in (s if isinstance(s, tuple) else (s,)):
            if a is not None:
                out[d] //= sizes[a]
    return tuple(out)


def _shape_faults(tree, specs, sizes, label, whole_plain=False):
    """Where a leaf's local shape (a DTensor's shard, a plain tensor
    whole) is not the spec's division of its global shape, or (without
    `whole_plain`) a leaf is not placed: a list of messages."""
    from repro_torch.convert import leaves
    from repro_torch.launch.dryrun import _walk
    bad = []
    pairs = list(_walk(tree, specs))
    if len(pairs) != len(leaves(tree)):
        bad.append(f"{label}: {len(leaves(tree))} leaves, {len(pairs)} "
                   "with specs")
    for x, s in pairs:
        want = _split_shape(tuple(x.shape), s, sizes)
        if not hasattr(x, "to_local"):
            if not whole_plain:
                bad.append(f"{label}: a plain {tuple(x.shape)} leaf")
            elif want != tuple(x.shape):
                bad.append(f"{label}: a plain {tuple(x.shape)} leaf that "
                           f"{s} splits")
            continue
        if tuple(x.to_local().shape) != want:
            bad.append(f"{label}: {tuple(x.shape)} by {s}: local "
                       f"{tuple(x.to_local().shape)}, want {want}")
    return bad


def _np(tree):
    from repro_torch.convert import leaves
    return [x.detach().cpu().numpy() for x in leaves(tree)]


def _port_arch(arch, inp, mesh):
    """Every case of one arch on `mesh` -> a dict of numpy results and the
    local-shape faults."""
    from repro_torch import convert
    from repro_torch.configs.base import AFLConfig, ModelConfig
    from repro_torch.core import cache as tcache
    from repro_torch.core.distributed import make_afl_train_step
    from repro_torch.models import build_model
    from repro_torch.optim import sgd
    from repro_torch.sharding import place
    from repro_torch.sharding.rules import axis_sizes
    cfg = ModelConfig(**inp["cfg"])
    model = build_model(cfg)
    params = convert.params_from_jax(inp["params"])
    sizes = axis_sizes(mesh)
    out, faults = {}, []
    batches = [{k: torch.as_tensor(v) for k, v in b.items()}
               for b in _train_batches(cfg.vocab_size)]
    for algo, cd in RULES:
        aflc = AFLConfig(algorithm=algo, n_clients=N_CLIENTS, tau_algo=TAU,
                         cache_dtype=cd)
        init_fn, step_fn = make_afl_train_step(model.loss_fn, aflc, sgd(LR))
        state, batch = place.place_train(init_fn(params), batches[0], mesh)
        specs = place.train_specs(state, batches[0], mesh)[0]
        if cd == "int8":
            # init over placed parameters places the state by the same specs
            faults += _shape_faults(init_fn(state.params), specs, sizes,
                                    f"{algo} {cd} init_fn(placed)", True)
        faults += _shape_faults(state, specs, sizes, f"{algo} {cd} state",
                                True)
        metrics = []
        for t, (j, tau) in enumerate(zip(CLIENTS, STALENESS)):
            if t:
                batch = place.place_batch(batches[t], mesh)
            faults += _shape_faults(
                batch, place.train_specs(state, batches[t], mesh)[1], sizes,
                f"{algo} {cd} batch {t}")
            state, m = step_fn(state, batch, j, tau)
            metrics.append({k: float(v) for k, v in m.items()})
            faults += _shape_faults(state, specs, sizes,
                                    f"{algo} {cd} state after step {t}",
                                    True)
        full = place.full_tree(state)
        run = "u" if algo == "ace" else "asum"
        out["train", algo, cd] = {
            "params": _np(full.params), "metrics": metrics,
            "cache": [x.numpy() for x in tcache.cache_tensors(
                full.afl["cache"])],
            "sum": _np(full.afl[run])}
    toks = torch.as_tensor(_tokens(2, (B, L), cfg.vocab_size))
    pp, pb = place.place_prefill(params, {"tokens": toks}, mesh)
    logits, _ = model.prefill(pp, pb)
    out["prefill"] = logits.full_tensor().numpy()
    for batch in (B, 1):
        cache = model.init_cache(batch, MAX_LEN, device="cpu")
        tk = toks[:batch, 0]
        c_spec = place.decode_specs(params, cache, tk, mesh)[1]
        pp, cache, ptk = place.place_decode(params, cache, tk, mesh)
        steps = []
        for pos in range(DECODE_STEPS):
            faults += _shape_faults(cache, c_spec, sizes,
                                    f"decode B={batch} cache at {pos}")
            logits, cache = model.decode_step(pp, cache, ptk, pos)
            lg = logits.full_tensor()
            steps.append(lg.numpy())
            ptk = place.place_batch(lg.argmax(-1), mesh)
        faults += _shape_faults(cache, c_spec, sizes,
                                f"decode B={batch} cache at the end")
        out["decode", batch] = steps
    return out, faults


def _progress(tmp, rank):
    with open(f"{tmp}/rank{rank}.progress", "ab") as f:
        f.write(b".")


def _wait_inputs(tmp):
    path = f"{tmp}/inputs.pkl"
    t0 = time.time()
    while not os.path.exists(path):
        if time.time() - t0 > STALL:
            raise TimeoutError("no inputs")
        time.sleep(0.1)
    with open(path, "rb") as f:
        return pickle.load(f)


def _rank_main(rank, tmp):
    """One rank: every arch on every mesh; results or the traceback into
    `tmp`."""
    import warnings
    import torch.distributed as dist
    warnings.filterwarnings("ignore")
    torch.set_num_threads(1)
    out = {}
    try:
        dist.init_process_group(
            "gloo", init_method=f"file://{tmp}/pg", rank=rank,
            world_size=WORLD, timeout=timedelta(seconds=60))
        from repro_torch.sharding.rules import build_mesh
        inputs = _wait_inputs(tmp)
        for mname, shape in MESHES.items():
            mesh = build_mesh(shape, ("data", "model"))
            for arch in ARCHS:
                out[mname, arch] = _port_arch(arch, inputs[arch], mesh)
                _progress(tmp, rank)
        dist.destroy_process_group()
        with open(f"{tmp}/rank{rank}.pkl", "wb") as f:
            pickle.dump(out, f)
    except BaseException:
        with open(f"{tmp}/rank{rank}.err", "w") as f:
            f.write(traceback.format_exc())
        raise


# ---------------------------------------------------------------------------
# The parent's side: JAX's weights and references.
# ---------------------------------------------------------------------------

def _jax_arch(arch, jparams):
    """JAX's unsharded train steps, prefill and decode on the inputs the
    ranks use."""
    import jax
    import jax.numpy as jnp
    from repro.configs.base import AFLConfig
    from repro.core.distributed import make_afl_train_step
    from repro.models import build_model
    from repro.optim import sgd
    cfg = _jax_cfg(arch)
    model = build_model(cfg)
    out = {}
    batches = [{k: jnp.asarray(v) for k, v in b.items()}
               for b in _train_batches(cfg.vocab_size)]
    for algo, cd in RULES:
        aflc = AFLConfig(algorithm=algo, n_clients=N_CLIENTS, tau_algo=TAU,
                         cache_dtype=cd)
        init_fn, step_fn = make_afl_train_step(model.loss_fn, aflc, sgd(LR))
        step_fn = jax.jit(step_fn)
        state, metrics = init_fn(jparams), []
        for b, j, tau in zip(batches, CLIENTS, STALENESS):
            state, m = step_fn(state, b, jnp.int32(j), jnp.int32(tau))
            metrics.append({k: float(v) for k, v in m.items()})
        run = "u" if algo == "ace" else "asum"
        out["train", algo, cd] = {
            "params": [np.asarray(x) for x in jax.tree.leaves(state.params)],
            "metrics": metrics,
            "cache": [np.asarray(x) for x in
                      jax.tree.leaves(state.afl["cache"])],
            "sum": [np.asarray(x) for x in jax.tree.leaves(state.afl[run])]}
    toks = jnp.asarray(_tokens(2, (B, L), cfg.vocab_size))
    logits, _ = jax.jit(model.prefill)(jparams, {"tokens": toks})
    out["prefill"] = np.asarray(logits)
    decode = jax.jit(model.decode_step)
    for batch in (B, 1):
        cache = model.init_cache(batch, MAX_LEN)
        tk, steps = toks[:batch, 0], []
        for pos in range(DECODE_STEPS):
            logits, cache = decode(jparams, cache, tk, jnp.int32(pos))
            steps.append(np.asarray(logits))
            tk = jnp.argmax(logits, -1).astype(jnp.int32)
        out["decode", batch] = steps
    return out


def _done(tmp):
    paths = (f"{tmp}/rank{r}.progress" for r in range(WORLD))
    return sum(os.path.getsize(p) for p in paths if os.path.exists(p))


def _join(procs, tmp, t0):
    """Wait for the ranks while they make progress (as
    tests/test_torch_scan_sharded.py's join)."""
    done, seen = _done(tmp), time.time()
    while True:
        codes = [p.exitcode for p in procs]
        bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
        now = time.time()
        if _done(tmp) != done:
            done, seen = _done(tmp), now
        late = now - seen > STALL or now - t0 > DEADLINE
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
        pytest.fail((f"ranks stalled ({done} pieces done in "
                     f"{now - t0:.0f} s)" if late else
                     f"ranks {bad} failed") + "\n" + "\n".join(errs[:1]))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{"ranks": [each rank's results], "jax": {arch: JAX's results}}."""
    import multiprocessing
    import sys
    import jax
    from repro.models import build_model
    from repro_torch.configs.base import ModelConfig  # noqa: F401
    sys.path.insert(0, os.path.dirname(__file__))
    tmp = str(tmp_path_factory.mktemp("model_sharded"))
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(r, tmp), daemon=True)
             for r in range(WORLD)]
    t0 = time.time()
    for p in procs:
        p.start()
    try:
        jparams, inputs = {}, {}
        for arch in ARCHS:
            cfg = _jax_cfg(arch)
            jparams[arch] = build_model(cfg).init(jax.random.PRNGKey(0))
            inputs[arch] = {"cfg": dataclasses.asdict(cfg), "params":
                            jax.tree.map(np.asarray, jparams[arch])}
        with open(f"{tmp}/inputs.tmp", "wb") as f:
            pickle.dump(inputs, f)
        os.replace(f"{tmp}/inputs.tmp", f"{tmp}/inputs.pkl")
        jax_ref = {arch: _jax_arch(arch, jparams[arch]) for arch in ARCHS}
    except BaseException:
        for p in procs:
            p.kill()
        raise
    _join(procs, tmp, t0)
    ranks = []
    for r in range(WORLD):
        with open(f"{tmp}/rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return {"ranks": ranks, "jax": jax_ref}


def _close(a, b, tol=1e-5):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), rtol=tol, atol=tol)


CASES = [(m, a) for m in MESHES for a in ARCHS]


@pytest.mark.parametrize("rule", RULES, ids=lambda r: "-".join(r))
@pytest.mark.parametrize("mesh,arch", CASES)
def test_placed_train_steps_match_jax(runs, mesh, arch, rule):
    """(a) on every rank: two placed steps against JAX's unsharded ones."""
    ref = runs["jax"][arch]["train", *rule]
    for rank in runs["ranks"]:
        got = rank[mesh, arch][0]["train", *rule]
        for pm, jm in zip(got["metrics"], ref["metrics"]):
            for k in ("loss", "grad_norm", "update_norm"):
                np.testing.assert_allclose(pm[k], jm[k], rtol=1e-4,
                                           atol=1e-6)
        allowance = [np.zeros_like(p) for p in ref["params"]]
        if rule[1] == "int8":
            q_p, s_p = got["cache"][0::2], got["cache"][1::2]
            q_j, s_j = ref["cache"][0::2], ref["cache"][1::2]
            off = total = 0
            for i, (a, b, sa, sb) in enumerate(zip(q_p, q_j, s_p, s_j)):
                np.testing.assert_allclose(sa, sb, rtol=1e-5, atol=0)
                step = np.abs(a.astype(np.int32) - b.astype(np.int32))
                assert step.max() <= 1
                off, total = off + int(step.sum()), total + step.size
                # a moved code moves the running sum by its scale / n, and
                # the parameter by lr times that
                share = step * sb.reshape((-1,) + (1,) * (step.ndim - 1))
                allowance[i] = LR * share.sum(0) / N_CLIENTS
            assert off <= total * 1e-4, (off, total)
        else:
            for a, b in zip(got["cache"], ref["cache"]):
                _close(a, b)
            for a, b in zip(got["sum"], ref["sum"]):
                _close(a, b)
        assert len(got["params"]) == len(ref["params"])
        for a, b, extra in zip(got["params"], ref["params"], allowance):
            assert a.shape == b.shape
            assert (np.abs(a - b) <= 1e-5 + 1e-5 * np.abs(b)
                    + extra * 1.001).all(), float(np.abs(a - b).max())


@pytest.mark.parametrize("mesh,arch", CASES)
def test_placed_prefill_matches_jax(runs, mesh, arch):
    """(b) the last position's logits."""
    for rank in runs["ranks"]:
        _close(rank[mesh, arch][0]["prefill"], runs["jax"][arch]["prefill"])


@pytest.mark.parametrize("batch", [B, 1])
@pytest.mark.parametrize("mesh,arch", CASES)
def test_placed_decode_matches_jax(runs, mesh, arch, batch):
    """(c) four steps from an empty cache: logits, and so the fed-back
    argmax tokens, JAX's."""
    ref = runs["jax"][arch]["decode", batch]
    for rank in runs["ranks"]:
        got = rank[mesh, arch][0]["decode", batch]
        assert len(got) == len(ref) == DECODE_STEPS
        for a, b in zip(got, ref):
            _close(a, b)
            assert (a.argmax(-1) == b.argmax(-1)).all()


@pytest.mark.parametrize("mesh,arch", CASES)
def test_local_shapes_are_the_specs_division(runs, mesh, arch):
    """(d) params, optimizer and AFL state, batches and decode caches."""
    for rank in runs["ranks"]:
        assert rank[mesh, arch][1] == []
