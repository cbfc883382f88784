"""Serving scenario: batched prefill and decode for three architecture
families (dense GQA, MLA, SSM) through one decode-step API — on the
PyTorch/CUDA port (`repro_torch`), the twin of `examples/serve_batch.py`.

Run:  PYTHONPATH=src python examples/torch_serve_batch.py [--device cpu]
"""
import argparse

from repro_torch.launch.serve import main as serve_main

ARCHS = ("gemma2-2b", "minicpm3-4b", "mamba2-780m")


def main(device=None):
    """Serve each reduced arch on `device` (None: the card) -> {arch:
    generated tokens (2, 16)}."""
    dev = ["--device", device] if device else []
    out = {}
    for arch in ARCHS:
        print(f"=== {arch} (reduced) ===")
        out[arch] = serve_main(["--arch", arch, "--reduced", "--batch", "2",
                                "--prompt-len", "16", "--gen", "16", *dev])
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="'cpu', or a CUDA device (default: the card)")
    main(ap.parse_args().device)
