"""ACED on the LM task's reduced zamba2 (K = 1 and 3) and reduced qwen3-moe
(K = 3), the port's tree-layout engine within 1e-5 of JAX's tree runner
on the same weights and JAX's replayed streams; the cases, helpers and
tolerances are tests/test_torch_lm_more.py's (a file of its own to keep
each file's time short)."""
import pytest

torch = pytest.importorskip("torch")

from test_torch_lm_more import check_runs  # noqa: E402


@pytest.mark.parametrize("name,K", [("zamba2", 1), ("zamba2", 3),
                                    ("qwen3-moe", 3)])
def test_tree_engine_matches_jax_tree_aced(name, K):
    check_runs(name, "aced", K)
