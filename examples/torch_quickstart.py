"""Quickstart: ACE (All-Client Engagement AFL) in ~40 lines — on the
PyTorch/CUDA port (`repro_torch`), the twin of `examples/quickstart.py`.

Simulates 20 clients with non-IID data and exponential delays; the server
updates the global model on every arrival using the ACE incremental rule
(paper Alg. a.5, int8 cache), then compares against Vanilla ASGD.

Run:  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.core import (ACEIncremental, StalenessSimulator,
                              VanillaASGD, make_vision_task)

N_CLIENTS, T, BETA = 20, 300, 5.0


def main(device=None):
    """Run both rules on `device` (None: the card) -> {name: (simulator,
    SimResult)}."""
    task = make_vision_task(n_clients=N_CLIENTS, alpha=0.1, n_train=4000,
                            n_test=1000, dim=32, hidden=(64,), batch=10,
                            seed=0, device=device)
    lr = 0.2 * np.sqrt(N_CLIENTS / T)

    results = {}
    for name, agg in [("ACE", ACEIncremental(cache_dtype="int8")),
                      ("Vanilla ASGD", VanillaASGD())]:
        sim = StalenessSimulator(
            grad_fn=task.grad_fn, params0=task.params0, aggregator=agg,
            n_clients=N_CLIENTS, server_lr=lr, beta=BETA,
            eval_fn=task.eval_fn, eval_every=100, seed=1, device=device)
        result = sim.run(T)
        results[name] = (sim, result)
        accs = " -> ".join(f"{e['accuracy']:.3f}" for e in result.evals)
        print(f"{name:13s} accuracy over training: {accs} "
              f"({result.total_comms} client uploads)")
    return results


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="'cpu', or a CUDA device (default: the card)")
    main(ap.parse_args().device)
