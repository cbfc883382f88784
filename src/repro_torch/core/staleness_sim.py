"""Constants of the sampled-staleness protocol shared with the engine — a
copy of the module-level pieces of `repro.core.staleness_sim` (the host
simulator itself is not ported yet)."""
from __future__ import annotations

import numpy as np

#: sentinel iteration for "never": a client with ``leave_at == NEVER`` is
#: always on; one with ``rejoin_at == NEVER`` never comes back.
NEVER: int = int(np.iinfo(np.int32).max)

#: per-event fault kinds of a `FaultSchedule`: NONE passes the payload
#: through; NAN poisons it with a non-finite multiplier (quarantined by the
#: guard pipeline); EXPLODE scales it by the schedule's per-event scale
#: (caught by global-norm clipping); BYZANTINE flips its sign (finite:
#: clipped, never quarantined); OVERSTALE forces the requested staleness
#: past tau_max (rejected by the over-stale guard).
FAULT_NONE: int = 0
FAULT_NAN: int = 1
FAULT_EXPLODE: int = 2
FAULT_BYZANTINE: int = 3
FAULT_OVERSTALE: int = 4


def default_tau_max(beta: float) -> int:
    """History bound when none is given; covers essentially all Exp(β)
    draws (P[τ > 6β+20] < e⁻⁶)."""
    return int(6 * beta + 20)


def staleness_client_probs(n_clients: int, speed_skew: float) -> np.ndarray:
    """Participation probabilities: uniform, or log-spaced speed weights in
    [1/(1+skew), 1+skew] (normalised) to create participation imbalance."""
    if speed_skew > 0:
        w = np.exp(np.linspace(-np.log(1 + speed_skew),
                               np.log(1 + speed_skew), n_clients))
        return w / w.sum()
    return np.full(n_clients, 1.0 / n_clients)
