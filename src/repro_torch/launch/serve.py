"""Batched serving driver — the port of `repro.launch.serve`: prefill a
batch of prompts by stepping the per-layer KV/SSM decode cache over them,
then decode tokens one step at a time.

The prompts come from ``np.random.default_rng(seed)`` as the JAX package
draws them, so both packages serve the same prompts; sampling draws Gumbel
noise from a `torch.Generator` seeded with ``--seed`` on the run's device
(`jax.random.categorical`'s stream is not reproduced).

Example:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-780m \\
      --reduced --batch 4 --prompt-len 64 --gen 32 --device cpu
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.registry import get_config
from repro_torch.kernels.backend import resolve_device
from repro_torch.models import build_model


def make_prompts(vocab: int, batch: int, prompt_len: int, seed: int,
                 device=None) -> torch.Tensor:
    """(batch, prompt_len) int32 token ids, the JAX package's draw."""
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.integers(0, vocab, size=(batch, prompt_len)),
                           dtype=torch.int32).to(device)


def generate(model, params, prompts: torch.Tensor, n_gen: int,
             temperature: float, generator: torch.Generator):
    """Prefill by stepping ``model.decode_step`` over `prompts` (B, P), then
    generate `n_gen` tokens: the first the last prompt step's argmax, each
    later one sampled at `temperature` by Gumbel-max with noise from
    `generator` (on the prompts' device). -> (tokens (B, n_gen) int32, the
    last prompt step's logits (B, vocab))."""
    B, P = prompts.shape
    cache = model.init_cache(B, P + n_gen, device=prompts.device)
    out = []
    with torch.no_grad():
        for t in range(P):
            logits, cache = model.decode_step(params, cache, prompts[:, t], t)
        last = logits
        tok = torch.argmax(logits, -1).to(torch.int32)
        for t in range(P, P + n_gen):
            out.append(tok)
            logits, cache = model.decode_step(params, cache, tok, t)
            gumbel = -torch.log(torch.empty_like(
                logits, dtype=torch.float32).exponential_(generator=generator))
            tok = torch.argmax(logits.float() / temperature + gumbel,
                               -1).to(torch.int32)
    tokens = (torch.stack(out, 1) if out else
              torch.zeros((B, 0), dtype=torch.int32, device=prompts.device))
    return tokens, last


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> np.ndarray:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma2-2b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="the run's device (default: the GPU)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = build_model(cfg)
    params = model.init(torch.Generator(device=device).manual_seed(args.seed))
    print(f"model={cfg.name} params={cfg.param_count()/1e6:.1f}M "
          f"device={device}")
    prompts = make_prompts(cfg.vocab_size, args.batch, args.prompt_len,
                           args.seed, device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    _sync(device)
    t0 = time.time()
    tokens, last = generate(model, params, prompts, args.gen,
                            args.temperature, gen)
    _sync(device)
    dt = time.time() - t0
    if not bool(torch.isfinite(last).all()):
        raise RuntimeError("non-finite logits")
    out = tokens.cpu().numpy()
    steps = args.prompt_len + args.gen
    print(f"prefill {args.prompt_len} toks + generated {args.gen} toks "
          f"x{args.batch}: {dt:.2f}s ({1e3 * dt / steps:.2f} ms a step, "
          f"{args.gen * args.batch / dt:.1f} tok/s)")
    print("sample token ids:", out[0][:16].tolist())
    return out


if __name__ == "__main__":
    main()
