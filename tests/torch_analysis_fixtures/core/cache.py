# ruff: noqa
"""TRC004 true positives: cache, ring and snapshot buffers allocated under a
mesh in a sharding-contract module (core/cache.py) without a split from
guarded_spec or BlockedFlatCache."""
import torch

from repro_torch.sharding.rules import shard


def init_ring(mesh, slots, d):  # EXPECT[TRC004]
    ring = torch.zeros((slots, d), dtype=torch.float32)
    return ring


def init_snapshots(mesh, marks, d):  # EXPECT[TRC004]
    # shard() hands its argument back whole: it splits nothing
    snaps = torch.zeros((marks, d), dtype=torch.float32)
    return shard(snaps, (None, "cache_d"))


def init_client_cache(n, d, rules):  # EXPECT[TRC004]
    mesh = rules.mesh
    cache = torch.empty((n, d), dtype=torch.int8)
    return cache
