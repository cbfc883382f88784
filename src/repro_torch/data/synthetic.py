"""Deterministic synthetic datasets — the offline stand-ins for CIFAR-10
and 20 Newsgroups. Copies of `repro.data.synthetic`'s functions (plain
numpy, the same arrays from the same seed):

* ``make_classification``: a K-class mixture of Gaussians with
  class-dependent means on a hypersphere plus per-class low-rank structure;
* ``make_token_stream``: an order-k Markov token generator for LM
  training (the LM task's data): learnable structure, deterministic seed;
* ``make_text_classification``: token sequences whose class sets the token
  distribution (the text task's data);
* ``batch_iterator``: uniform minibatches with replacement, forever.

Heterogeneity comes from Dirichlet label partitioning
(`repro_torch.data.partition`), matching the paper's non-IID protocol.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def make_classification(n: int = 10000, n_classes: int = 10, dim: int = 64,
                        noise: float = 0.6, seed: int = 0
                        ) -> Tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(seed)
    means = rng.normal(size=(n_classes, dim))
    means /= np.linalg.norm(means, axis=1, keepdims=True)
    means *= 2.5
    basis = rng.normal(size=(n_classes, dim, 4)) * 0.5
    y = rng.integers(0, n_classes, size=n)
    z = rng.normal(size=(n, 4))
    x = means[y] + np.einsum("ndk,nk->nd", basis[y], z) + \
        rng.normal(size=(n, dim)) * noise
    return x.astype(np.float32), y.astype(np.int32)


def make_token_stream(n_tokens: int = 1 << 20, vocab: int = 512,
                      order: int = 2, seed: int = 0) -> np.ndarray:
    """Markov chain over a hashed context — learnable synthetic language."""
    rng = np.random.default_rng(seed)
    n_states = 4096
    # sparse-ish transition table: each state prefers a few tokens
    prefs = rng.integers(0, vocab, size=(n_states, 8))
    toks = np.zeros(n_tokens, np.int32)
    h = 0
    mix = rng.integers(1, 1 << 30, size=order) | 1
    for t in range(n_tokens):
        if rng.random() < 0.15:
            nxt = rng.integers(0, vocab)
        else:
            nxt = prefs[h % n_states, rng.integers(0, 8)]
        toks[t] = nxt
        h = (h * 1315423911 + int(nxt) * int(mix[t % order])) & 0x7FFFFFFF
    return toks


def make_text_classification(n: int = 8000, n_classes: int = 20,
                             seq_len: int = 64, vocab: int = 1024,
                             seed: int = 0
                             ) -> Tuple[np.ndarray, np.ndarray]:
    """Class-conditional unigram token sequences (20NG stand-in)."""
    rng = np.random.default_rng(seed)
    # each class has a topic distribution concentrated on a token subset
    topic_logits = rng.normal(size=(n_classes, vocab)) * 2.0
    topic = np.exp(topic_logits)
    topic /= topic.sum(1, keepdims=True)
    y = rng.integers(0, n_classes, size=n).astype(np.int32)
    x = np.zeros((n, seq_len), np.int32)
    for i in range(n):
        x[i] = rng.choice(vocab, size=seq_len, p=topic[y[i]])
    return x, y


def batch_iterator(x: np.ndarray, y: np.ndarray, batch: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    n = len(x)
    while True:
        ix = rng.integers(0, n, size=batch)
        yield x[ix], y[ix]
