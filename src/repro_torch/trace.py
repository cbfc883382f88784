"""Spans of the port's layers in a torch.profiler trace.

``with span(name):`` marks a host range while a torch profiler runs, and
does nothing otherwise: it hands back one shared null context, with no
allocation and no record, so the program carries no switch for it. The
ranges land in the profiler's own trace, on the clock of its device
operations, so a device operation can be put down to the span whose host
range launched it, and an idle gap to the span the host was in.

The spans, outermost first (the runner's in `core/scan_engine.py`, the
engine's in `core/scan_staleness.py`, the model's in `models/ssm.py`):

  ``runner.feed``    a call's streams and inputs copied into the static
                     buffers (`_Ticks.feed`)
  ``runner.init``    the program's init and its carry put in place
  ``init.payload``   the init batch: the n clients' first gradients
  ``init.rule_state``  the rule's state from them (`init_state`: the
                     int8 cache fill) and u⁰ applied
  ``init.ring``      the history ring reset and its first rows written
  ``runner.ticks``   every event of the call (`_Ticks.run`)
  ``tick``           one tick run eagerly (a replay runs no host code, so
                     a replayed tick has no span); its children cover it:
  ``tick.sample``    availability, the Gumbel choice of the clients, τ
  ``tick.ring_read`` the stale models read from the ring
  ``tick.payload``   the clients' gradients, forward and backward
  ``tick.rule``      the fault guards, the rule's step, the frozen tick's
                     restore and the resync
  ``tick.apply``     the emitted update applied to the model
  ``tick.ring_write`` the new model written to the ring
  ``tick.outs``      the checks, the snapshots and the event's outputs
  ``tick.carry``     the new carry copied into the carry's own tensors
  ``ssd.chunked``    one forward of the SSD's chunked scan
                     (`models.ssm.ssd_chunked`); its backward runs later on
                     autograd's thread, outside the range

A runner counts the ticks it ran eagerly (``runner.eager_ticks``, beside
``runner.captures``), which a reader of the ``tick`` spans divides by.

`span` rests on two private names of torch, ``torch._C._profiler.
_RecordFunctionFast`` and ``torch.autograd.profiler._is_profiler_enabled``,
both present in torch 2.11 and 2.13; a torch that renames either breaks
every call made under a running profiler.
"""
from __future__ import annotations

import contextlib

import torch
from torch.autograd import profiler as _profiler

_NULL = contextlib.nullcontext()


def span(name: str):
    """A host range called `name` in the running torch profiler's trace,
    or the shared null context when no profiler runs.

    The range is recorded as an operation of the trace
    (``_RecordFunctionFast``), not as a user annotation
    (``torch.profiler.record_function``): with CUDA activity on, kineto
    mirrors each user annotation on the device's timeline as one event
    from the first kernel launched inside it to the last, which a reader
    of the device's operations would count as a device operation and its
    whole length as busy time."""
    if not _profiler._is_profiler_enabled:
        return _NULL
    return torch._C._profiler._RecordFunctionFast(name)
