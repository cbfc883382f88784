"""The LM task (`repro_torch.core.make_lm_task`) on the families the
attention-only slice did not build, against the JAX package's
`make_lm_task` on the same weights (`convert.params_from_jax`) and JAX's
replayed streams, with tests/test_torch_lm_task.py's helpers, task
settings (n = 4 clients, batch 2, seq 32 — one SSD chunk —, 2^14 tokens,
T = 12) and tolerances:

  * a reduced zamba2-1.2b (its (mamba ×5, shared_attn) unit once, d_model
    64, vocab 128; the shared block at model level, windowed): the lane
    losses and gradients within 1e-5 of JAX's `model.loss_fn` on the same
    windows, and the tree-layout engine with f32 caches — ACE here, ACED
    in tests/test_torch_lm_more_aced.py, each at K = 1 and K = 3 — within
    1e-5 of JAX's ``layout="tree"`` runner (model, losses, update norms,
    the rule's state);
  * a reduced qwen3-moe (2 layers, 4 experts, top-2, the router's aux
    term in the loss): the lane gradients here, ACED K = 3 in the other
    file. A router tie would flip an expert choice between the packages;
    none does in these runs.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.registry import get_config as jget_config  # noqa: E402
from repro_torch import convert  # noqa: E402
from test_torch_lm_task import (both_runs, check_tree_run,  # noqa: E402
                                jax_lm_grad, lanes, tasks)
from test_torch_tree_engine import close  # noqa: E402

torch.set_num_threads(1)

CFGS = {
    "zamba2": jget_config("zamba2-1.2b").reduced(layers=6, d_model=64,
                                                  vocab=128),
    "qwen3-moe": jget_config("qwen3-moe-235b-a22b").reduced(
        layers=2, d_model=64, vocab=128),
}


def check_runs(name, rule, K):
    """`rule` with f32 caches at K on the reduced `name` model: the port's
    tree run within 1e-5 of JAX's, updates emitted."""
    jax_run, port_run, _ = both_runs(rule, "float32", K, CFGS[name])
    assert int(port_run[2]["emit"].sum()) > 0
    check_tree_run(jax_run, port_run)


@pytest.mark.parametrize("name", list(CFGS))
def test_lane_losses_and_gradients_match_jax(name):
    """Two lanes (w⁰ and w⁰ moved by small numpy draws; clients 0 and 3)
    of the port's batched tree gradient against JAX's value_and_grad on
    each."""
    cfg = CFGS[name]
    _, ttask, params0 = tasks(cfg)
    grad_fn, noise_of = jax_lm_grad(cfg)
    jgrad = jax.jit(grad_fn)
    models = lanes(params0, 2)
    clients = np.array([0, 3], np.int32)
    keys = jax.random.split(jax.random.PRNGKey(11), 2)
    u = np.stack([np.asarray(noise_of(k)) for k in keys])
    w = convert.tree_map(lambda *xs: torch.stack(xs), *models)
    loss, g = ttask.grad_fn(w, torch.as_tensor(clients), torch.as_tensor(u))
    for b in range(2):
        jp = jax.tree.map(jnp.asarray, convert.tree_map(
            lambda x: x.numpy(), models[b]))
        jl, jg = jgrad(jp, jnp.int32(clients[b]), keys[b])
        assert float(loss[b]) == pytest.approx(float(jl), abs=1e-5)
        close(convert.tree_map(lambda x: x[b], g), jg)


@pytest.mark.parametrize("K", [1, 3])
def test_tree_engine_matches_jax_tree_ace(K):
    check_runs("zamba2", "ace", K)
