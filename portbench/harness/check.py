"""The comparison that decides `correct`: what the window's last call
produced against the plain reference run over the same inputs.

The numbers read (a cell compares those its limits file names, each
beside its own limit):

* ``loss_gap``, ``loss_first``: the widest relative gap of an event's
  client loss, over every event of the call or over its first `FIRST`
  (the payload through the model, the stale model each client read from
  the int8 history);
* ``unorm_gap``, ``unorm_first``: the same of the norm of the update each
  event applied (the server rule at every event);
* ``change_gap``, ``change_med``: the worst and the median leaf's gap
  between the norms of the model's change over the call, w - w0;
* ``update_gap``, ``update_med``: the same of the rule's update after the
  call (ACE's running mean);
* ``cache_gap``, ``cache_med``: the same over (leaf, client) of the norms
  of the dequantized cache rows (codes and scales).

A leaf's gap is measured against its reference norm or the median leaf's,
whichever is larger. Leaves whose first reference gradient is nought to
rounding (under a thousandth of the median leaf's norm) move by round-off
alone and are left out of the leaf gaps. Over many events an int8 code
that rounds the other way on one side (a difference of one step, up to
1/127 of a row's largest number) carries on through the history ring, so
a small leaf's gap and the later events' read the same for any two
computations that differ at all: the first events and the median leaf
are what separates the precisions.
"""
from __future__ import annotations

import statistics
from typing import Dict, List

import torch

#: the first events, before int8 code flips carry a difference on
FIRST = 3
#: a leaf whose first gradient is under this share of the median leaf's
#: is left out of the leaf gaps
NOUGHT = 1e-3


def norm(x) -> float:
    return float(torch.linalg.vector_norm(x.float(), dtype=torch.float64))


def _series_gap(prog: List[float], ref: List[float]) -> float:
    if len(prog) != len(ref):
        return float("inf")
    gaps = [abs(a - b) / max(abs(b), 1e-30) for a, b in zip(prog, ref)]
    return max(gaps) if gaps else 0.0


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], keep):
    """{leaf: the gap of its norms against max(its reference norm, the
    median leaf's)} over the leaves in `keep`; None where the two sides
    hold different leaves."""
    if set(prog) != set(ref):
        return None
    med = statistics.median(ref.values())
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
            for k in ref if k in keep}


def _worst(gaps) -> float:
    if gaps is None:
        return float("inf")
    return max(gaps.values()) if gaps else 0.0


def _median(gaps) -> float:
    if gaps is None:
        return float("inf")
    return statistics.median(gaps.values()) if gaps else 0.0


def moving_leaves(first_grad: Dict[str, torch.Tensor]) -> set:
    norms = {k: norm(v) for k, v in first_grad.items()}
    med = statistics.median(norms.values())
    return {k for k, v in norms.items() if v >= NOUGHT * med}


def _all_leaf_gaps(prog: Dict, ref: Dict) -> Dict:
    keep = ref["moving"]
    rows_p = {f"{k}[{i}]": x for k, xs in prog["cache"].items()
              for i, x in enumerate(xs)}
    rows_r = {f"{k}[{i}]": x for k, xs in ref["cache"].items()
              for i, x in enumerate(xs)}
    keep_rows = {r for r in rows_r if r.split("[")[0] in keep}
    return {"change": leaf_gaps(prog["change"], ref["change"], keep),
            "update": leaf_gaps(prog["update"], ref["update"], keep),
            "cache": leaf_gaps(rows_p, rows_r, keep_rows)}


def worst_leaves(prog: Dict, ref: Dict) -> Dict[str, str]:
    """The leaf (or cache row) that sets each worst-leaf gap."""
    return {f"{k}_gap": (max(g, key=g.get) if g else None)
            for k, g in _all_leaf_gaps(prog, ref).items()}


def compare(prog: Dict, ref: Dict) -> Dict[str, float]:
    """Both sides as `summary` dicts -> {name: number}: the worst leaf's
    gap (``*_gap``) and the median leaf's (``*_med``) of each leaf
    quantity."""
    gaps = _all_leaf_gaps(prog, ref)
    out = {"loss_first": _series_gap(prog["losses"][:FIRST],
                                     ref["losses"][:FIRST]),
           "unorm_first": _series_gap(prog["unorms"][:FIRST],
                                      ref["unorms"][:FIRST]),
           "loss_gap": _series_gap(prog["losses"], ref["losses"]),
           "unorm_gap": _series_gap(prog["unorms"], ref["unorms"])}
    for k, g in gaps.items():
        out[f"{k}_gap"] = _worst(g)
        out[f"{k}_med"] = _median(g)
    bad = [x for x in prog["losses"] if x != x or x in (float("inf"),
                                                        float("-inf"))]
    if bad:
        out["loss_gap"] = out["loss_first"] = float("inf")
    return out


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Correct where every number the cell's limits name is at or under
    its limit (a NaN fails; no limits at all fail)."""
    return bool(limits) and all(numbers[name] <= limit
                                for name, limit in limits.items())


def reference_summary(cfg: dict, mix: dict, seed: int, device,
                      precision: str = "float32") -> Dict:
    """The plain reference over the run's inputs, made again from `seed`:
    the per-event losses and update norms, each leaf's change and update
    norms, the cache rows' norms and the leaves that move."""
    import reference
    from harness.inputs import TOKENS, Streams, lr_of, make_weights, sub_seed
    ref_task = reference.task(mix)(cfg, mix, sub_seed(seed, TOKENS), device,
                                   precision)
    w0 = make_weights(ref_task.model.shapes(), cfg["init"], seed, device)
    n, K = mix["n_clients"], mix["k_batch"]
    s = Streams(seed, mix["events_per_call"], n, K, mix["beta"], mix["batch"],
                device)
    rule = reference.rule(mix)(n, mix["cache_dtype"])
    first = []
    w, losses, unorms = reference.protocol(mix).run(
        grad=ref_task.grad, w0=w0, rule=rule, n=n, lr=lr_of(mix),
        tau_max=mix["tau_max"], history_dtype=mix["history_dtype"],
        gumbels=s.gumbels, tau_raw=s.tau_raw, noise_init=s.noise_init,
        noise_ticks=s.noise_ticks, first_grad=first)
    return {"losses": losses, "unorms": unorms,
            "change": {k: norm(w[k] - w0[k]) for k in w},
            "update": {k: norm(v) for k, v in rule.update().items()},
            "cache": rule.cache_norms(),
            "moving": moving_leaves(first[0])}
