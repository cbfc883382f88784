"""Scenario: client dropouts and the ACED delay threshold (paper Fig. 3) —
on the PyTorch/CUDA port (`repro_torch`), the twin of
`examples/aced_dropout.py`.

Half the clients permanently drop at t=T/2. Conceptual ACE keeps averaging
their frozen cache rows (non-vanishing bias B_drop, App. D.4.1); ACED's
active set ejects them after tau_algo iterations and recovers.

Run:  PYTHONPATH=src python examples/torch_aced_dropout.py [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.core import (ACED, ACEIncremental, StalenessSimulator,
                              VanillaASGD, make_vision_task)

n, T, beta = 30, 400, 5.0


def main(device=None):
    """Every run on `device` (None: the card) -> {(algo, dropout
    fraction): final accuracy}, the ablation under ("tau_algo", τ)."""
    task = make_vision_task(n_clients=n, alpha=0.3, n_train=6000,
                            n_test=1500, dim=32, hidden=(64,), batch=10,
                            seed=0, device=device)
    lr = 0.2 * np.sqrt(n / T)
    accs = {}

    print(f"{'algo':22s} {'dropout':>8s} {'final acc':>10s}")
    for frac in (0.0, 0.5):
        for name, agg in [("ACED(tau=10)", lambda: ACED(tau_algo=10)),
                          ("conceptual ACE", lambda: ACEIncremental()),
                          ("vanilla ASGD", lambda: VanillaASGD())]:
            sim = StalenessSimulator(
                grad_fn=task.grad_fn, params0=task.params0, aggregator=agg(),
                n_clients=n, server_lr=lr, beta=beta, eval_fn=task.eval_fn,
                eval_every=T, dropout_frac=frac, dropout_at=T // 2, seed=1,
                device=device)
            r = sim.run(T)
            acc = accs[name, frac] = r.final_eval()["accuracy"]
            print(f"{name:22s} {frac:8.0%} {acc:10.3f}")
        print()

    print("tau_algo ablation at 50% dropout (U-shape: bias vs staleness):")
    for tau in (1, 10, 50, 200):
        sim = StalenessSimulator(
            grad_fn=task.grad_fn, params0=task.params0,
            aggregator=ACED(tau_algo=tau), n_clients=n, server_lr=lr,
            beta=beta, eval_fn=task.eval_fn, eval_every=T, dropout_frac=0.5,
            dropout_at=T // 2, seed=1, device=device)
        r = sim.run(T)
        acc = accs["tau_algo", tau] = r.final_eval()["accuracy"]
        print(f"  tau_algo={tau:4d}  acc={acc:.3f}")
    return accs


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="'cpu', or a CUDA device (default: the card)")
    main(ap.parse_args().device)
