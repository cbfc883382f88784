"""MSE decomposition diagnostics (paper Eq. 3–4) — a copy of
`repro.core.mse` (plain numpy).

    u^t − ∇F(w^t) = A (noise) + B (bias) + C (delay)
      A = u^t − ū^t
      B = ū^t − ∇F(w_stale^t)
      C = ∇F(w_stale^t) − ∇F(w^t)

Given analytic per-client true gradients (available for the quadratic test
objectives of the test suite), these estimators verify the paper's Table 1 — in
particular ACE's Term-B ≡ 0 property and the σ²/n noise reduction."""
from __future__ import annotations

from typing import Callable, Dict, Sequence

import numpy as np


def decompose(u_t: np.ndarray, u_bar_t: np.ndarray, grad_stale: np.ndarray,
              grad_now: np.ndarray) -> Dict[str, float]:
    A = u_t - u_bar_t
    B = u_bar_t - grad_stale
    C = grad_stale - grad_now
    return {
        "A_sq": float(np.sum(A * A)),
        "B_sq": float(np.sum(B * B)),
        "C_sq": float(np.sum(C * C)),
        "mse": float(np.sum((u_t - grad_now) ** 2)),
    }


def expected_update_ace(true_grads_stale: np.ndarray) -> np.ndarray:
    """ū^t for ACE = mean of true gradients at the stale models actually used
    (the cache rows' generating models)."""
    return np.mean(true_grads_stale, axis=0)


def expected_update_subset(true_grads_stale: np.ndarray,
                           subset: Sequence[int]) -> np.ndarray:
    """ū^t for an m-client partial-participation update (FedBuff/ASGD, K=1)."""
    return np.mean(true_grads_stale[np.asarray(subset)], axis=0)


def grad_f_stale(true_grad_fn: Callable, stale_models: Sequence[np.ndarray]
                 ) -> np.ndarray:
    """∇F(w_stale) = (1/n) Σ_i ∇F_i(w^{t−τ_i}) — each client at *its* stale model."""
    n = len(stale_models)
    return np.mean([true_grad_fn(i, stale_models[i]) for i in range(n)], axis=0)
