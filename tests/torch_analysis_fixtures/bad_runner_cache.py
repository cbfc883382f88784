# ruff: noqa
"""TRC005 true positives: memoised runner factories whose cache key misses a
parameter."""
import torch

_RUNNER_CACHE = {}
_K_CACHE = {}


def leaky_runner(n_clients, horizon, beta):
    key = (n_clients, horizon)  # EXPECT[TRC005]
    if key not in _RUNNER_CACHE:
        _RUNNER_CACHE[key] = lambda x: x * n_clients + horizon + beta
    return _RUNNER_CACHE[key]


def leaky_k_runner(n_clients, horizon, k_batch=1):
    # a K = 1 and a K = 16 runner capture different ticks, but this key
    # hands both the same runner (and its graph)
    key = (n_clients, horizon)  # EXPECT[TRC005]
    if key not in _K_CACHE:
        _K_CACHE[key] = lambda x: torch.full_like(x, horizon * k_batch)
    return _K_CACHE[key]
