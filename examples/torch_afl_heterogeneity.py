"""Scenario: heterogeneity amplification and why all-client engagement
fixes it — on the PyTorch/CUDA port (`repro_torch`), the twin of
`examples/afl_heterogeneity.py`.

Reproduces the paper's central mechanism on the theory-exact quadratic
testbed: client optima spread zeta (heterogeneity), staleness tau ~ Exp(beta).
Partial-participation baselines' error floors scale with zeta; ACE's floor is
zeta-invariant (Theorem 1 needs no bounded-heterogeneity assumption).

Run:  PYTHONPATH=src python examples/torch_afl_heterogeneity.py [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.core import (ACEIncremental, FedBuff, StalenessSimulator,
                              VanillaASGD)
from repro_torch.core.fl_tasks import ClientGrad
from repro_torch.kernels.backend import resolve_device

n, d, sigma, T, lr = 40, 30, 0.3, 600, 0.02


def main(device=None):
    """Every (algo, zeta, beta) cell on `device` (None: the card) ->
    {(algo, zeta, beta): steady-state error}."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    dirs = rng.normal(size=(n, d))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)

    errors = {}
    print(f"{'algo':10s} {'zeta':>5s} {'beta':>5s} "
          f"{'steady-state error':>20s}")
    for name, mk in [("ace", lambda: ACEIncremental()),
                     ("fedbuff", lambda: FedBuff(buffer_size=5)),
                     ("asgd", lambda: VanillaASGD())]:
        for zeta in (0.5, 4.0):
            for beta in (2, 20):
                C = torch.as_tensor(dirs * zeta, dtype=torch.float32)
                w_star = C.mean(0).numpy()
                C = C.to(dev)

                def grad(w, clients, noise, C=C):
                    # g = w − C_client + σ·ξ, ξ ~ N(0, I) of shape (d,)
                    return (torch.zeros(w.shape[0], device=w.device),
                            w - C[clients] + sigma * noise)

                sim = StalenessSimulator(
                    grad_fn=ClientGrad(grad, (d,), "normal"),
                    params0=torch.as_tensor(w_star) + 1.0, aggregator=mk(),
                    n_clients=n, server_lr=lr, beta=beta, seed=2, device=dev)
                sim.run(T)
                err = float(np.sum((sim.w.cpu().numpy() - w_star) ** 2))
                errors[name, zeta, beta] = err
                print(f"{name:10s} {zeta:5.1f} {beta:5.0f} {err:20.4f}")
        print()
    return errors


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="'cpu', or a CUDA device (default: the card)")
    main(ap.parse_args().device)
