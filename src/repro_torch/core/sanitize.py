"""Runtime invariant checks for the port's engines — the counterpart of
`repro.core.sanitize` (the JAX package's checkify sanitizers).

The checks are JAX's, with its messages:

  * the server model (and any payload actually applied) stays finite;
  * the history-ring write cursor and the ACED owner-ring slots stay in
    bounds (a corrupted slot silently aliases another client's expiry);
  * the active-set counts stay in [0, n];
  * a K-arrival batch holds distinct in-range clients with staleness in
    [0, tau_max], and its commit keeps the update and the running sums
    finite and grows the count by at most its valid lanes;
  * the incremental running sums agree with the exact recompute at every
    `resync_every` point.

A captured tick cannot raise, so a check here is a predicate computed on
the device (``True`` = holds), returned as ``(message, predicate)`` pairs.
With checks on, the engine's carry holds one 0-d int64 record per message
(`records`): the first event at which the check failed, or −1, updated by
`record` with `torch.where` and never read inside the run. The runner reads
the records after the run (the chunked runner after each chunk), and
`raise_first` raises `RuntimeError` with the message and the event. Off
means off: no record and no op, so the tick is the unchecked one.

`enabled` resolves the switch: an explicit argument wins, else the JAX
package's ``REPRO_CHECKIFY`` environment variable (default off).
"""
from __future__ import annotations

import os
from typing import Dict, Iterable, List, Optional, Tuple

import torch

from repro_torch.convert import leaves

#: tolerance of the incremental-vs-resync agreement: the incremental path
#: accumulates one f32 rounding per event, the recompute sums n rows once
RESYNC_RTOL = 1e-3

MODEL = "checkify: non-finite server model"
PAYLOAD = "checkify: non-finite payload applied"
CURSOR = "checkify: ring cursor out of bounds"
RING = "checkify: owner-ring slot out of bounds"
COUNT = "checkify: active-set count out of range"
BATCH_CLIENT = "checkify: batch arrival client index out of range"
BATCH_DUPLICATE = "checkify: duplicate client in arrival batch"
BATCH_STALENESS = "checkify: batch arrival staleness out of range"
COMMIT_UPDATE = "checkify: non-finite commit update"
COMMIT_COUNT = "checkify: commit count conservation violated"
RESYNC = "checkify: incremental sums diverged from resync recompute"
#: the running sums `check_commit_batch` holds finite, where a state has them
COMMIT_SUMS = ("u", "asum", "init_sum", "h_sum", "h_bar", "accum")

Check = Tuple[str, torch.Tensor]


def commit_sum_message(key: str) -> str:
    return f"checkify: non-finite running sum after commit ({key})"


def enabled(override: Optional[bool] = None) -> bool:
    """Resolve the switch: explicit `override` wins, else the
    ``REPRO_CHECKIFY`` environment variable (default off)."""
    if override is not None:
        return bool(override)
    return os.environ.get("REPRO_CHECKIFY", "0").strip().lower() not in (
        "", "0", "false", "off", "no")


def _finite(x) -> torch.Tensor:
    """All of a tensor finite, or of every floating leaf of a structure (the
    tree layout), as JAX's `_finite_pred`."""
    if isinstance(x, torch.Tensor):
        return torch.isfinite(x).all()
    return torch.stack([torch.isfinite(t).all() for t in leaves(x)
                        if t.is_floating_point()]).all()


def check_model_finite(w) -> List[Check]:
    """`w` has no NaN/Inf — post guard, post update."""
    return [(MODEL, _finite(w))]


def check_payload_finite(payload, applied) -> List[Check]:
    """An *applied* payload (emitted, not quarantined) must be finite;
    payloads the guards dropped are exempt."""
    return [(PAYLOAD, ~applied | _finite(payload))]


def check_cursor_bounds(cursor, n_slots: int) -> List[Check]:
    """The history-ring write cursor stays a valid slot index."""
    return [(CURSOR, (cursor >= 0) & (cursor < n_slots))]


def state_messages(state) -> List[str]:
    """The messages `check_aggregator_state` gives for `state`'s fields."""
    out = [RING] if "ring" in state else []
    if "count" in state or "init_count" in state:
        out.append(COUNT)
    return out


def check_aggregator_state(state, n_clients: int) -> List[Check]:
    """Rule-state invariants keyed on the state's own fields: every ACED
    owner-ring slot is −1 (empty) or a client in [0, n); the active-set
    sizes ``count`` / ``init_count`` lie in [0, n]."""
    out = []
    ring = state.get("ring")
    if ring is not None:
        out.append((RING, ((ring >= -1) & (ring < n_clients)).all()))
    counts = [state[k] for k in ("count", "init_count") if k in state]
    if counts:
        ok = torch.stack([((c >= 0) & (c <= n_clients)).all()
                          for c in counts]).all()
        out.append((COUNT, ok))
    return out


BATCH_MESSAGES = (BATCH_CLIENT, BATCH_DUPLICATE, BATCH_STALENESS)


def check_batch_arrivals(clients, staleness, valid, n_clients: int,
                         tau_max: int) -> List[Check]:
    """The K-arrival batch contract the batched cache writes rely on: every
    *valid* lane holds a client in [0, n), the valid lanes' clients are
    pairwise distinct, and their staleness lies in [0, tau_max]. An invalid
    lane is exempt."""
    js, tau = clients.long(), staleness.long()
    in_range = ~valid | ((js >= 0) & (js < n_clients))
    pair = valid[:, None] & valid[None, :] & (js[:, None] == js[None, :])
    off_diag = ~torch.eye(js.shape[0], dtype=torch.bool, device=js.device)
    tau_ok = ~valid | ((tau >= 0) & (tau <= tau_max))
    return [(BATCH_CLIENT, in_range.all()),
            (BATCH_DUPLICATE, ~(pair & off_diag).any()),
            (BATCH_STALENESS, tau_ok.all())]


def commit_messages(state) -> List[str]:
    """The messages `check_commit_batch` gives for a rule with `state`."""
    out = [COMMIT_UPDATE]
    out += [commit_sum_message(k) for k in COMMIT_SUMS if k in state]
    if "count" in state:
        out.append(COMMIT_COUNT)
    return out


def check_commit_batch(update, state_new, state_old, valid) -> List[Check]:
    """The K-arrival commit: the emitted update and every running-sum
    vector stay finite, and one batch grows ``count`` by at most its number
    of valid lanes (expiry, emit-flush and the init-cohort fire only shrink
    it; a larger jump means a lane was double-counted)."""
    out = [(COMMIT_UPDATE, _finite(update))]
    out += [(commit_sum_message(k), _finite(state_new[k]))
            for k in COMMIT_SUMS if k in state_new]
    if "count" in state_new:
        nv = valid.sum(dtype=torch.int32)
        out.append((COMMIT_COUNT,
                    state_new["count"] - state_old["count"] <= nv))
    return out


def check_resync_agreement(incremental, resynced, when) -> List[Check]:
    """Where `when` holds (a `resync_every` point: the engine computes the
    recompute every tick), the exact O(n·d) recompute agrees with the
    incrementally tracked sums within ``RESYNC_RTOL · (1 + max|exact|)``.
    Only the floating tensors the recompute replaced are compared; the
    others are the incremental state's own."""
    ok = torch.ones((), dtype=torch.bool, device=when.device)
    for k, exact in resynced.items():
        # a resync hands back what it does not recompute (the caches too)
        if exact is incremental[k]:
            continue
        # a tree-layout sum is compared leaf by leaf, as JAX's check does
        for a, b in zip(leaves(incremental[k]), leaves(exact)):
            if not b.is_floating_point():
                continue
            b = b.float()
            tol = RESYNC_RTOL * (1.0 + b.abs().max())
            ok = ok & ((a.float() - b).abs().max() <= tol)
    return [(RESYNC, ~when | ok)]


def records(messages: Iterable[str], device) -> Dict[str, torch.Tensor]:
    """One 0-d int64 record per message, each −1 (no violation), in the
    checks' order."""
    return {m: torch.full((), -1, dtype=torch.int64, device=device)
            for m in messages}


def record(recs: Dict[str, torch.Tensor], checks: Iterable[Check],
           e: torch.Tensor) -> None:
    """Write event `e` (0-d int64) into the record of each check that fails
    and has no earlier failure, in place and on the device."""
    for message, ok in checks:
        r = recs[message]
        r.copy_(torch.where((r < 0) & ~ok, e, r))


def raise_first(recs: Dict[str, torch.Tensor], offset: int = 0) -> None:
    """Read the records (one host copy) and raise `RuntimeError` for the
    earliest failed event, the first check in order at that event, as
    JAX's checkify reports the first failure; `offset` is the events before
    the records' first one (a chunk's start)."""
    if not recs:
        return
    names = list(recs)
    firsts = torch.stack([recs[m] for m in names]).cpu().tolist()
    failed = [(e, i) for i, e in enumerate(firsts) if e >= 0]
    if failed:
        e, i = min(failed)
        raise RuntimeError(f"{names[i]} at event {offset + e}")
