"""The synthetic language the LM task trains on, made again from the seed
for the reference: a Markov chain over a hashed context of the last
`order` tokens (the repository's `make_token_stream`, frozen here)."""
from __future__ import annotations

import numpy as np


def make_token_stream(n_tokens: int, vocab: int, order: int = 2,
                      seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    n_states = 4096
    # each hashed state prefers 8 tokens; one draw in 0.15 is uniform
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
