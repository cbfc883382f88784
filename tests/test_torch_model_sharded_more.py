"""The rest of the port's model laid out by JAX's specs
(`repro_torch.sharding.place`): the MoE FFN with its experts over
``model``, the Mamba-2 SSD with its heads over ``model``, zamba2's shared
attention block and the encoder-decoder's cross-attention, and a
checkpoint of a placed state — on four CPU ``gloo`` ranks that this file
starts itself, held against the JAX package's own unsharded functions on
the same weights and inputs, as tests/test_torch_model_sharded.py holds
the attention-only decoders (whose helpers this file imports).

Reduced f32 configs (d_model 64, vocab 128), on the ``("data", "model")``
meshes (2, 2), (4, 1) and (1, 4) of one 4-rank group unless said:

  * qwen3-moe-235b-a22b, one layer of 8 experts (2 a rank on ``model`` =
    4), top-2, QK-norm;
  * arctic-480b, one layer of 8 experts beside its dense residual FFN, on
    (2, 2) alone;
  * mamba2-780m, two layers of 4 heads (split over ``model`` = 2 and 4),
    and a variant of 6 heads (``ssm_expand`` 3: split over 2, whole over 4 —
    the guard), on (2, 2) and (1, 4);
  * zamba2-1.2b, one unit of its pattern (5 mamba layers and the shared
    attention block);
  * seamless-m4t-medium, one encoder layer and one decoder layer (its
    cross-attention over the frame embeddings, and in decode the zero
    cross cache, ROADMAP C13).

  (a) `make_afl_train_step`, two steps in a row, for ACE with an f32 tree
      cache and ACED int8 (and ACE int8 on (2, 2)), held as
      tests/test_torch_model_sharded.py holds them: parameters within 1e-5
      (plus lr · scale / n where an int8 code moved), loss, grad_norm and
      update_norm within rtol 1e-4, codes equal or one step off at most
      once in 10^4 (a moved code allowed for at every step that reads its
      row), scales within 1e-5 relative or 1e-6 of the step's
      largest scale (a near-cancelling gradient, ROADMAP C20);
  (b) `prefill`: the last position's logits within 1e-5;
  (c) four `decode_step`s from an empty cache at B = 4 and B = 1: logits
      within 1e-5 at each step and the argmax tokens equal (the MoE at a
      capacity factor of 16, where no token is dropped, as chip_smoke.py's
      ``MOE_DECODE_CAPACITY``);
  (d) local shapes of parameters, optimizer and AFL state, batches and the
      decode cache (the SSD's ``state`` and ``conv``, the cross cache)
      against the specs' division, before and after the steps;
  (e) on (2, 2): the placed ACED int8 state after one step saved
      (`save_checkpoint`: every rank gathers, rank 0 writes) and restored
      into the placed initial state is bit for bit, with its placements
      and its plain leaves kept; JAX's `restore_checkpoint`, in the
      parent, reads the same file to the same numbers.
"""
import dataclasses
import os
import pickle
import sys
import time
import traceback
from datetime import timedelta

import numpy as np
import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, os.path.dirname(__file__))

from test_torch_model_sharded import (STALL, WORLD, _close,  # noqa: E402
                                      _join, _np, _progress, _shape_faults,
                                      _tokens)

torch.set_num_threads(1)

MESHES = {"2x2": (2, 2), "4x1": (4, 1), "1x4": (1, 4)}
#: case -> (arch, `reduced()`'s keywords, fields replaced after, meshes)
ARCHS = {
    "qwen3-moe": ("qwen3-moe-235b-a22b", dict(layers=1, experts=8), {},
                  tuple(MESHES)),
    "arctic": ("arctic-480b", dict(layers=1, experts=8), {}, ("2x2",)),
    "mamba2": ("mamba2-780m", dict(layers=2), {}, tuple(MESHES)),
    "mamba2-h6": ("mamba2-780m", dict(layers=2), dict(ssm_expand=3),
                  ("2x2", "1x4")),
    "zamba2": ("zamba2-1.2b", dict(layers=6), {}, tuple(MESHES)),
    "seamless": ("seamless-m4t-medium", dict(layers=1),
                 dict(num_encoder_layers=1), tuple(MESHES)),
}
#: (algorithm, cache dtype) of the train steps on each mesh
RULES = {"2x2": (("ace", "float32"), ("aced", "int8"), ("ace", "int8")),
         "4x1": (("ace", "float32"), ("aced", "int8")),
         "1x4": (("ace", "float32"), ("aced", "int8"))}
CKPT_RULE = ("aced", "int8")
N_CLIENTS, LR, TAU = 4, 0.1, 3
CLIENTS, STALENESS = (0, 1), (1, 2)
#: the steps at which each cache row is read by the running sum: from the
#: step that writes it to the last
READS = np.array([len(CLIENTS) - CLIENTS.index(r) if r in CLIENTS else 0
                  for r in range(N_CLIENTS)], np.float32)
B, L, MAX_LEN, DECODE_STEPS = 4, 16, 16, 4
MOE_DECODE_CAPACITY = 16.0
#: the parent's processes that draw JAX's weights and compute its
#: references, a case each at a time, beside the ranks
JAX_WORKERS = 3


def _jax_cfg(case, decode=False):
    from repro.configs.registry import get_config
    arch, kw, over, _ = ARCHS[case]
    cfg = get_config(arch).reduced(d_model=64, vocab=128, **kw)
    cfg = dataclasses.replace(cfg, dtype="float32", **over)
    if decode and cfg.is_moe:
        cfg = dataclasses.replace(cfg, capacity_factor=MOE_DECODE_CAPACITY)
    return cfg


def _frames(seed, cfg, batch):
    """The encoder-decoder's frame embeddings (B, L / ratio, d)."""
    return np.random.default_rng(seed).standard_normal(
        (batch, L // cfg.encoder_frames_ratio, cfg.d_model)).astype(
            np.float32)


def _train_batches(cfg):
    toks = _tokens(1, (len(CLIENTS), B, L + 1), cfg.vocab_size)
    out = [{"tokens": t[:, :-1], "targets": t[:, 1:]} for t in toks]
    if cfg.is_encoder_decoder:
        for i, b in enumerate(out):
            b["audio_embeds"] = _frames(10 + i, cfg, B)
    return out


def _prefill_batch(cfg):
    out = {"tokens": _tokens(2, (B, L), cfg.vocab_size)}
    if cfg.is_encoder_decoder:
        out["audio_embeds"] = _frames(20, cfg, B)
    return out


# ---------------------------------------------------------------------------
# The port's side: what a rank runs.
# ---------------------------------------------------------------------------

def _same_state(a, b):
    """Whether two placed trees hold the same numbers bit for bit, each
    DTensor in the same placements and each plain leaf plain."""
    from repro_torch.convert import leaves
    from repro_torch.sharding import place
    for x, y in zip(leaves(a), leaves(b), strict=True):
        if hasattr(x, "to_local") != hasattr(y, "to_local"):
            return False
        if hasattr(x, "to_local") and not place.same_layout(x, y):
            return False
    return all(torch.equal(x, y) for x, y in zip(
        leaves(place.full_tree(a)), leaves(place.full_tree(b))))


def _port_case(case, inp, mesh, mname, tmp):
    """Every case of one arch on `mesh` -> a dict of numpy results and the
    local-shape faults."""
    from repro_torch import convert
    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
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
               for b in _train_batches(cfg)]
    for algo, cd in RULES[mname]:
        aflc = AFLConfig(algorithm=algo, n_clients=N_CLIENTS, tau_algo=TAU,
                         cache_dtype=cd)
        init_fn, step_fn = make_afl_train_step(model.loss_fn, aflc, sgd(LR))
        state, batch = place.place_train(init_fn(params), batches[0], mesh)
        first = state
        specs = place.train_specs(state, batches[0], mesh)[0]
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
            if t == 0 and mname == "2x2" and (algo, cd) == CKPT_RULE:
                directory = f"{tmp}/ckpt_{case}"
                save_checkpoint(directory, 1, state)
                back = restore_checkpoint(directory, 1, first)
                # copies: the next step writes the tree cache in place
                out["ckpt"] = {"dir": directory,
                               "same": _same_state(back, state),
                               "leaves": [x.copy() for x in _np(
                                   place.full_tree(state))]}
        full = place.full_tree(state)
        run = "u" if algo == "ace" else "asum"
        out["train", algo, cd] = {
            "params": _np(full.params), "metrics": metrics,
            "cache": [x.numpy() for x in tcache.cache_tensors(
                full.afl["cache"])],
            "sum": _np(full.afl[run])}
    pb = {k: torch.as_tensor(v) for k, v in _prefill_batch(cfg).items()}
    pp, pb = place.place_prefill(params, pb, mesh)
    logits, _ = model.prefill(pp, pb)
    out["prefill"] = logits.full_tensor().numpy()
    model = build_model(ModelConfig(**inp["decode_cfg"]))
    toks = torch.as_tensor(_prefill_batch(cfg)["tokens"])
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


def _wait_case(tmp, case):
    """The inputs of `case`, once a JAX worker has written them."""
    path = f"{tmp}/inputs_{case}.pkl"
    t0 = time.time()
    while not os.path.exists(path):
        if time.time() - t0 > STALL:
            raise TimeoutError(f"no inputs for {case}")
        time.sleep(0.1)
    with open(path, "rb") as f:
        return pickle.load(f)


def _rank_main(rank, tmp):
    """One rank: every case on each of its meshes (the inputs of each as
    they come); results or the traceback into `tmp`."""
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
        inputs = {}
        for mname, shape in MESHES.items():
            mesh = build_mesh(shape, ("data", "model"))
            for case, (_, _, _, meshes) in ARCHS.items():
                if mname in meshes:
                    if case not in inputs:
                        inputs[case] = _wait_case(tmp, case)
                    out[mname, case] = _port_case(case, inputs[case], mesh,
                                                  mname, tmp)
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

def _jax_case(case, tmp):
    """One JAX worker's case: JAX's weights drawn and written for the ranks
    (`inputs_<case>.pkl`), then its unsharded train steps, prefill and
    decode on the inputs the ranks use, and its initial ACED int8 state
    (the checkpoint's template) as numpy."""
    import jax
    import jax.numpy as jnp
    from repro.configs.base import AFLConfig
    from repro.core.distributed import make_afl_train_step
    from repro.models import build_model
    from repro.optim import sgd
    cfg = _jax_cfg(case)
    model = build_model(cfg)
    jparams = jax.jit(model.init)(jax.random.PRNGKey(0))
    inputs = {"cfg": dataclasses.asdict(cfg),
              "decode_cfg": dataclasses.asdict(_jax_cfg(case, True)),
              "params": jax.tree.map(np.asarray, jparams)}
    with open(f"{tmp}/inputs_{case}.tmp", "wb") as f:
        pickle.dump(inputs, f)
    os.replace(f"{tmp}/inputs_{case}.tmp", f"{tmp}/inputs_{case}.pkl")
    out = {}
    batches = [{k: jnp.asarray(v) for k, v in b.items()}
               for b in _train_batches(cfg)]
    rules = {r for m in ARCHS[case][3] for r in RULES[m]}
    for algo, cd in sorted(rules):
        aflc = AFLConfig(algorithm=algo, n_clients=N_CLIENTS, tau_algo=TAU,
                         cache_dtype=cd)
        init_fn, step_fn = make_afl_train_step(model.loss_fn, aflc, sgd(LR))
        step_fn = jax.jit(step_fn)
        state, metrics = init_fn(jparams), []
        if (algo, cd) == CKPT_RULE:
            out["template"] = jax.tree.map(np.asarray, state)
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
    batch = {k: jnp.asarray(v) for k, v in _prefill_batch(cfg).items()}
    logits, _ = jax.jit(model.prefill)(jparams, batch)
    out["prefill"] = np.asarray(logits)
    model = build_model(_jax_cfg(case, decode=True))
    decode = jax.jit(model.decode_step)
    for batch in (B, 1):
        cache = model.init_cache(batch, MAX_LEN)
        tk, steps = jnp.asarray(_prefill_batch(cfg)["tokens"])[:batch, 0], []
        for pos in range(DECODE_STEPS):
            logits, cache = decode(jparams, cache, tk, jnp.int32(pos))
            steps.append(np.asarray(logits))
            tk = jnp.argmax(logits, -1).astype(jnp.int32)
        out["decode", batch] = steps
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{"ranks": [each rank's results], "jax": {case: JAX's results}}: the
    ranks and `JAX_WORKERS` processes computing JAX's side run together."""
    import multiprocessing
    tmp = str(tmp_path_factory.mktemp("model_sharded_more"))
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(r, tmp), daemon=True)
             for r in range(WORLD)]
    t0 = time.time()
    for p in procs:
        p.start()
    try:
        with ctx.Pool(JAX_WORKERS) as pool:
            refs = pool.starmap(_jax_case, [(c, tmp) for c in ARCHS],
                                chunksize=1)
        jax_ref = dict(zip(ARCHS, refs))
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


def _hold_train(got, ref, rule):
    """(a)'s tolerances (tests/test_torch_model_sharded.py's)."""
    for pm, jm in zip(got["metrics"], ref["metrics"]):
        for k in ("loss", "grad_norm", "update_norm"):
            np.testing.assert_allclose(pm[k], jm[k], rtol=1e-4, atol=1e-6)
    allowance = [np.zeros_like(p) for p in ref["params"]]
    if rule[1] == "int8":
        q_p, s_p = got["cache"][0::2], got["cache"][1::2]
        q_j, s_j = ref["cache"][0::2], ref["cache"][1::2]
        # a scale is max|g| / 127, and an f32 sum is exact to about an
        # ulp of the magnitudes it adds: a leaf whose gradient nearly
        # cancels (the SSD's A_log, 1e-4 of the step's largest gradient)
        # is held within 1e-6 of the row's largest scale (ROADMAP C20)
        row_max = np.max(np.stack(s_j), axis=0)
        off = total = 0
        for i, (a, b, sa, sb) in enumerate(zip(q_p, q_j, s_p, s_j)):
            assert (np.abs(sa - sb) <= 1e-5 * np.abs(sb)
                    + 1e-6 * row_max).all(), (i, sa, sb)
            step = np.abs(a.astype(np.int32) - b.astype(np.int32))
            assert step.max() <= 1
            off, total = off + int(step.sum()), total + step.size
            # a moved code moves the running sum by its scale / n, and the
            # parameter by lr times that at each step from its row's write
            # on (the sum reads every row at every step)
            share = step * (sb * READS).reshape((-1,) + (1,) * (step.ndim
                                                                - 1))
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


CASES = [(m, c) for m in MESHES for c, a in ARCHS.items() if m in a[3]]
TRAIN = [(m, c, r) for m, c in CASES for r in RULES[m]]


@pytest.mark.parametrize("mesh,case,rule", TRAIN,
                         ids=[f"{m}-{c}-{'-'.join(r)}" for m, c, r in TRAIN])
def test_placed_train_steps_match_jax(runs, mesh, case, rule):
    """(a) on every rank: two placed steps against JAX's unsharded ones."""
    ref = runs["jax"][case]["train", *rule]
    for rank in runs["ranks"]:
        _hold_train(rank[mesh, case][0]["train", *rule], ref, rule)


@pytest.mark.parametrize("mesh,case", CASES)
def test_placed_prefill_matches_jax(runs, mesh, case):
    """(b) the last position's logits."""
    for rank in runs["ranks"]:
        _close(rank[mesh, case][0]["prefill"], runs["jax"][case]["prefill"])


@pytest.mark.parametrize("batch", [B, 1])
@pytest.mark.parametrize("mesh,case", CASES)
def test_placed_decode_matches_jax(runs, mesh, case, batch):
    """(c) four steps from an empty cache: logits, and so the fed-back
    argmax tokens, JAX's."""
    ref = runs["jax"][case]["decode", batch]
    for rank in runs["ranks"]:
        got = rank[mesh, case][0]["decode", batch]
        assert len(got) == len(ref) == DECODE_STEPS
        for a, b in zip(got, ref):
            _close(a, b)
            assert (a.argmax(-1) == b.argmax(-1)).all()


@pytest.mark.parametrize("mesh,case", CASES)
def test_local_shapes_are_the_specs_division(runs, mesh, case):
    """(d) params, optimizer and AFL state, batches and decode caches."""
    for rank in runs["ranks"]:
        assert rank[mesh, case][1] == []


@pytest.mark.parametrize("case", [c for c, a in ARCHS.items()
                                  if "2x2" in a[3]])
def test_placed_checkpoint_round_trips_and_jax_reads_it(runs, case):
    """(e) a placed state saved after one step and restored into a placed
    template, bit for bit on every rank; JAX's restore reads the file that
    rank 0 wrote to the numbers the ranks held."""
    import jax
    from repro.checkpoint import restore_checkpoint
    saved = [rank["2x2", case][0]["ckpt"] for rank in runs["ranks"]]
    assert all(s["same"] for s in saved)
    template = runs["jax"][case]["template"]
    back = restore_checkpoint(saved[0]["dir"], 1, template)
    got = [np.asarray(x) for x in jax.tree.leaves(back)]
    assert len(got) == len(saved[0]["leaves"])
    for s in saved:
        for a, b in zip(got, s["leaves"]):
            assert a.dtype == b.dtype and np.array_equal(a, b)
