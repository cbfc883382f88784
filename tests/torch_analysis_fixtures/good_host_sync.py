# ruff: noqa
"""Clean twins of bad_host_sync: the same code shapes without a host sync."""
import torch


class _Program:
    def __init__(self, init, tick):
        self.init, self.tick = init, tick


class Cache:
    def __init__(self, data):
        self.data = data

    @property
    def quantized(self) -> bool:
        return self.data.dtype == torch.int8


def _fused(cache, vecs) -> bool:
    """Host checks only: a call annotated to return a bool is a host
    value."""
    return isinstance(cache, Cache) and all(
        v.dtype == torch.float32 for v in vecs)


def cuda_scalar(x, device):
    if not isinstance(x, torch.Tensor):     # x is a Python number here
        x = torch.full((), float(x), dtype=torch.float32, device=device)
    return x.reshape(())


def make_program(n, guards: bool):
    def tick(carry, xs, outs):
        t = carry["t"]
        carry["t"] = torch.where(t > 3, t - 1, t)     # select, not branch
        if guards:                  # a static flag of the factory
            carry["w"] = carry["w"].clamp(-1, 1)
        if carry.get("checks") is not None:       # structure, not value
            carry["checks"].zero_()
        if "snaps" in carry:        # a key of the carry dict
            carry["snaps"].zero_()
        if carry["w"].shape[0] > 2:     # .shape is host metadata
            carry["w"] = carry["w"][:2]
        K = carry["rows"].shape[0]
        carry["cohort"][:K] = carry["rows"]       # K stays a host int
        if K > n:
            raise ValueError("too many rows")
        for key, v in carry.items():
            if key == "e":          # the keys are strings
                v.add_(1)
        cache = carry["cache"]
        if cache.quantized and _fused(cache, (carry["w"],)):
            carry["w"] = carry["w"] * 2
        lr = cuda_scalar(xs["lr"], carry["w"].device)
        outs["loss"] = carry["w"].sum() * lr
        return carry
    return _Program(init=None, tick=tick)


def host_driver(runner, x):
    # host code, never captured: it may read values freely
    out = runner(x)
    return float(out.sum()), out.item(), out.cpu().tolist()
