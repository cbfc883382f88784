"""The comparison that decides `correct`, at a tiny size on the CPU: the
port's whole run (set-up, window, check) against the plain reference is
correct; with the timed path broken underneath it is not; the control,
the reference in TF32 put in the port's place, is not. The control at a
cell's own size on the card is `test_control_fails_on_the_card`."""
import json
import time

import pytest

from portbench_testlib import REPO, TINY_LIMITS, make_tiny_root
from harness import cell, check

KINDS = ["attn", "qk", "hybrid", "ssm"]

SEED = 3_000_000_019


def _run(root, seed=SEED):
    return cell.run("tiny.cell", seed, 0.2, False, root=root,
                    t_start=time.perf_counter(), device="cpu",
                    log=lambda msg: None)


@pytest.mark.parametrize("kind", KINDS)
def test_port_agrees_with_the_reference(tmp_path, kind):
    res = _run(make_tiny_root(tmp_path, kind))
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks"
    for c in res["checks"].values():
        assert c["value"] <= c["limit"]
    assert res["attempted"] == 6 * res["calls"] and res["failed"] == 0


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "answer_altered"])
@pytest.mark.parametrize("kind", KINDS)
def test_a_broken_timed_path_is_not_correct(tmp_path, kind, fault):
    """`calibrate.faults`' faults planted in the port: a rule that keeps
    its state, half of each batch, every gradient scaled by 1.001."""
    import calibrate
    from harness import port as port_mod
    root = make_tiny_root(tmp_path, kind)
    plant, undo = calibrate.faults(port_mod.load(REPO))[fault]
    plant()
    try:
        res = _run(root)
    finally:
        undo()
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("seed", [11, 12, 13])
@pytest.mark.parametrize("kind", KINDS)
def test_control_is_not_correct(tmp_path, kind, seed):
    """The reference in TF32 (its products' inputs rounded to TF32 on the
    CPU) in the port's place fails one of the limits."""
    spec = cell.load_spec("tiny.cell", make_tiny_root(tmp_path, kind))
    ref = check.reference_summary(spec.cfg, spec.mix, seed, "cpu")
    ctl = check.reference_summary(spec.cfg, spec.mix, seed, "cpu", "tf32")
    assert not check.verdict(check.compare(ctl, ref), TINY_LIMITS)
    assert check.verdict(check.compare(ref, ref), TINY_LIMITS)


def test_an_untied_head_the_program_lacks_is_refused(tmp_path):
    """A configuration whose output table is its own (``tie_embeddings``
    false) has an ``unembed`` leaf in the reference; the program, which
    builds no untied head, is refused before any call."""
    root = make_tiny_root(tmp_path, "attn", tie_embeddings=False)
    with pytest.raises(RuntimeError, match="unembed"):
        _run(root)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [
    w["name"] for w in json.loads((REPO / "BENCHMARK.json").read_text())
    ["workloads"]])
def test_control_fails_on_the_card(card, workload):
    """The control at the cell's own size on the card: the reference in
    TF32 against the reference in f32 fails the cell's limits."""
    spec = cell.load_spec(workload, REPO)
    ref = check.reference_summary(spec.cfg, spec.mix, SEED, card)
    ctl = check.reference_summary(spec.cfg, spec.mix, SEED, card, "tf32")
    assert not check.verdict(check.compare(ctl, ref), spec.limits)
