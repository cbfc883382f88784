"""tracecheck for the PyTorch port — capture-safety / sharding-contract
static analyzer (the port's counterpart of `repro.analysis`).

The port's CUDA-graph tick replays bit for bit what its eager tick computes
only while a few conventions hold everywhere captured code is written: no
host syncs inside the tick, every random draw from a caller-seeded
`torch.Generator` (and none inside the tick, which reads the streams drawn
before it), dtypes pinned in `core/`, the blocked server state split by one
rule, memoised runners keyed on every static. This package checks them
mechanically. It is its own copy: it imports nothing of `repro`.

Pure stdlib (`ast`): it runs without torch. Entry points::

    python -m repro_torch.analysis [paths...]   # or repro-torch-tracecheck

Rules (each suppressible in source with ``# tracecheck: ignore[RULE]`` on
the offending line, and grandfathered by the committed baseline
``tracecheck_torch_baseline.json``, which is empty):

  TRC001  host syncs in captured code — ``.item()``, ``.tolist()``,
          ``.cpu()``, ``.numpy()``; ``float()``/``int()``/``bool()`` of a
          tensor; ``torch.nonzero``/``masked_select``/``unique`` (a
          data-dependent output shape); a Python ``if``/``while`` (or
          ``assert``) on a tensor.
  TRC002  RNG — in library code, a ``torch.rand*``/``randn``/``randint``/
          ``randperm``/``normal``/``bernoulli``/``multinomial`` call or an
          in-place ``uniform_``/``normal_``/``exponential_`` draw without
          ``generator=``; in captured code, any draw at all (torch,
          ``np.random``, ``random``). JAX's key-reuse check has no
          counterpart: a generator is stateful.
  TRC003  dtypes — ``torch.zeros/ones/full/empty/arange/tensor`` without
          ``dtype=`` in ``core/`` (the ``*_like`` calls inherit theirs); a
          float literal beyond f32 precision in captured arithmetic.
  TRC004  sharding contract — a function of ``core/cache.py``,
          ``core/scan_sharded.py`` or ``core/distributed.py`` that allocates
          a cache, ring or snapshot buffer under a mesh and takes its split
          from neither ``sharding.rules.guarded_spec`` nor
          ``BlockedFlatCache`` (``shard()``/``replicate()`` hand their
          argument back in the port, so they prove nothing).
  TRC005  runner-cache keys — a memoised factory whose module-level cache
          key misses one of its parameters.

"Captured" is the tick's code: the ``tick`` bodies given to a program,
whatever a ``torch.cuda.graph`` block calls, the Aggregators'
``init_state``/``step``/``step_batch``/``resync``, every def of
``core/cache.py`` and ``kernels/``, and what they call
(`repro_torch.analysis.traceinfo`).
"""
from repro_torch.analysis.core import (RULES, Finding, load_baseline,
                                       run_tracecheck, write_baseline)

__all__ = ["Finding", "RULES", "load_baseline", "run_tracecheck",
           "write_baseline"]
