"""The LM task, plainly: client i trains on `batch` windows of seq + 1
tokens of its own contiguous region of the token stream (n_tokens // n
tokens), the windows' starts read from the payload noise u (batch,) as
lo + min(floor(u * (per - seq - 1)), per - seq - 2)."""
from __future__ import annotations

import torch

import reference
from reference.token_stream import make_token_stream


class Task:
    def __init__(self, cfg: dict, mix: dict, token_seed: int, device,
                 precision: str = "float32"):
        self.model = reference.model(cfg, precision)
        self.names = sorted(self.model.shapes())
        toks = make_token_stream(mix["n_tokens"], cfg["vocab_size"],
                                 seed=token_seed)
        self.toks = torch.as_tensor(toks).to(device=device,
                                             dtype=torch.int64)
        self.per = mix["n_tokens"] // mix["n_clients"]
        self.seq = mix["seq"]
        self.offsets = torch.arange(self.seq + 1, device=device)

    def grad(self, w, client: int, u):
        """(loss, {path: gradient}) of client `client` at the model `w`."""
        span = self.per - self.seq - 1
        starts = client * self.per + torch.clamp(
            torch.floor(u * float(span)).long(), max=span - 1)
        win = self.toks[starts[:, None] + self.offsets]
        loss, gs = self.model.grad(w, self.names, win[:, :-1], win[:, 1:])
        return loss, dict(zip(self.names, gs))
