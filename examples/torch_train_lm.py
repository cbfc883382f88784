"""End-to-end driver: asynchronously train a transformer LM with ACE — on
the PyTorch/CUDA port (`repro_torch`), the twin of `examples/train_lm.py`.

A thin wrapper over `repro_torch.launch.train.train` (the chunked engine on
a real model, tree layout): a ~0.8M-number yi-family reduced model by
default; --hundred-m for a ~100M-number model (the config the deliverable
names). Loss on the synthetic Markov token stream should fall from
~ln(vocab) toward ~2-3 within a few hundred steps; the script exits 0 when
the final loss is below 5.5.

Run:  PYTHONPATH=src python examples/torch_train_lm.py [--hundred-m]
          [--steps 300] [--device cpu]
"""
import argparse
import sys

from repro_torch.launch.train import train


def main(device=None, hundred_m=False, steps=300, algo="ace") -> float:
    """Train on `device` (None: the card) -> the final loss."""
    if hundred_m:
        # ~100M numbers: 8 layers x d_model 1024 (vocab 4096)
        size = dict(d_model=1024, layers=8, vocab=4096, seq=512)
    else:
        size = dict(d_model=256, layers=4, vocab=512, seq=256)
    return train(arch="yi-9b", reduced=True, batch=8, steps=steps,
                 algo=algo, device=device, **size)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--hundred-m", action="store_true")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--algo", default="ace")
    ap.add_argument("--device", default=None,
                    help="'cpu', or a CUDA device (default: the card)")
    a = ap.parse_args()
    final_loss = main(a.device, a.hundred_m, a.steps, a.algo)
    sys.exit(0 if final_loss < 5.5 else 1)
