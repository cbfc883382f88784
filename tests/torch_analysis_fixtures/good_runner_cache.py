# ruff: noqa
"""Clean twins of bad_runner_cache: every parameter reaches the key."""
import torch

_RUNNER_CACHE = {}
_K_CACHE = {}


def complete_runner(n_clients, horizon, beta):
    key = (n_clients, horizon, float(beta))
    if key not in _RUNNER_CACHE:
        _RUNNER_CACHE[key] = lambda x: x * n_clients + horizon + beta
    return _RUNNER_CACHE[key]


def complete_k_runner(n_clients, horizon, k_batch=1, graph=None):
    use_graph = bool(graph)
    key = (n_clients, horizon, int(k_batch), use_graph)
    if key not in _K_CACHE:
        _K_CACHE[key] = lambda x: torch.full_like(x, horizon * k_batch)
    return _K_CACHE[key]
