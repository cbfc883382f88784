# ruff: noqa
"""Clean twins of core/cache.py in another sharding-contract module: each
buffer under a mesh takes its split from guarded_spec (directly, or through
a block class or helper that does) or is a BlockedFlatCache."""
import torch

from repro_torch.core.cache import BlockedFlatCache
from repro_torch.sharding.rules import guarded_spec


class Block:
    def __init__(self, mesh, n, d):
        self.spec = guarded_spec((n, d), ("cache_clients", "cache_d"), mesh)
        self.rows, self.feats = n, d


def _block_shape(mesh, n, d):
    return Block(mesh, n, d).rows, Block(mesh, n, d).feats


def init_ring(mesh, slots, d):
    block = Block(mesh, slots, d)
    ring = torch.zeros((block.rows, block.feats), dtype=torch.float32)
    return ring


def init_snapshots(mesh, marks, d):
    rows, feats = _block_shape(mesh, marks, d)
    snaps = torch.zeros((rows, feats), dtype=torch.float32)
    return snaps


def init_client_cache(n, d, mesh):
    spec = guarded_spec((n, d), ("cache_clients", "cache_d"), mesh)
    store = torch.zeros((n, d), dtype=torch.int8)
    return BlockedFlatCache(store, spec)


def init_whole_cache(n, d):
    # no mesh: a whole buffer is the layout
    cache = torch.zeros((n, d), dtype=torch.float32)
    return cache
