"""The port's tracecheck (`repro_torch.analysis`): the fixture differential
against the ``# EXPECT[TRCnnn]`` markers of tests/torch_analysis_fixtures/,
every rule covered, suppressions, the baseline round trip, ``--rules``, a
syntax error as a finding, the CLI's exit codes and ``--summary``, and the
live `src/repro_torch` scanning clean with the committed empty baseline.

Also two standing rules of the port: no module of `src/repro_torch` (and
not chip_smoke.py) imports `repro` or `jax`; and the dtypes the analyzer
made the port pin in `core/` (TRC003) hold under a float64 default dtype.
"""
import ast
import os
import re
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro_torch.analysis import (RULES, load_baseline,  # noqa: E402
                                  run_tracecheck, write_baseline)
from repro_torch.analysis.core import load_modules  # noqa: E402
from repro_torch.analysis.traceinfo import build_index  # noqa: E402

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
FIXTURES = os.path.join(TESTS, "torch_analysis_fixtures")
SRC = os.path.join(REPO, "src", "repro_torch")
BASELINE = os.path.join(REPO, "tracecheck_torch_baseline.json")
#: the corpus's marked findings (its README's count)
N_MARKED = 37

_EXPECT_RE = re.compile(r"#\s*EXPECT\[(TRC\d{3})\]")


def _expected_markers():
    exp = set()
    for dirpath, _, files in os.walk(FIXTURES):
        for fn in sorted(files):
            if not fn.endswith(".py"):
                continue
            path = os.path.join(dirpath, fn)
            rel = os.path.relpath(path, FIXTURES).replace(os.sep, "/")
            with open(path, encoding="utf-8") as fh:
                for i, line in enumerate(fh, 1):
                    m = _EXPECT_RE.search(line)
                    if m:
                        exp.add((rel, i, m.group(1)))
    return exp


@pytest.fixture(scope="module")
def fixture_run():
    return run_tracecheck([FIXTURES], root=FIXTURES)


def test_fixture_corpus_differential(fixture_run):
    """Every EXPECT-marked line yields a finding with the marked rule id,
    nothing else does, and the clean twins yield nothing."""
    expected = _expected_markers()
    assert len(expected) == N_MARKED
    new, baselined, _ = fixture_run
    got = {(f.path, f.line, f.rule) for f in new}
    assert expected - got == set(), f"missed: {sorted(expected - got)}"
    assert got - expected == set(), f"spurious: {sorted(got - expected)}"
    assert len(new) == N_MARKED and baselined == []
    assert not [f for f in new if "good" in f.path
                or f.path == "core/scan_sharded.py"]


def test_fixture_corpus_covers_every_rule():
    rules_hit = {r for (_, _, r) in _expected_markers()}
    assert rules_hit == {"TRC001", "TRC002", "TRC003", "TRC004", "TRC005"}
    assert set(RULES) == rules_hit


def test_every_capture_root_is_seen(fixture_run):
    """TRC001 fires through each root of captured code: a program's tick,
    a torch.cuda.graph block's callee and what it calls, an Aggregator's
    step; host code beside them is not captured."""
    new, _, _ = fixture_run
    where = {re.search(r"captured '([^']+)'", f.message).group(1)
             for f in new if f.rule == "TRC001"}
    assert where == {"make_program.tick", "graph_step", "_inner",
                     "Rule.step"}
    index = build_index(load_modules([FIXTURES], root=FIXTURES))
    captured = {(fi.module.relpath, fi.qualname)
                for fi in index.traced_functions()}
    assert ("good_host_sync.py", "cuda_scalar") in captured
    assert ("good_host_sync.py", "host_driver") not in captured
    assert ("good_rng.py", "build_streams") not in captured


def test_inline_suppression_lands_in_suppressed_bucket(fixture_run):
    new, _, suppressed = fixture_run
    assert {(f.path, f.rule) for f in suppressed} == {
        ("suppressed.py", "TRC001"), ("suppressed.py", "TRC002")}
    assert not any(f.path == "suppressed.py" for f in new)


def test_repo_src_has_no_unbaselined_findings():
    """The acceptance gate: the analyzer over all of src/repro_torch (and
    chip_smoke.py) reports nothing beyond the committed baseline, which is
    empty."""
    new, baselined, suppressed = run_tracecheck(
        [SRC, os.path.join(REPO, "chip_smoke.py")], root=REPO,
        baseline=BASELINE)
    assert new == [], "\n".join(f.format() for f in new)
    assert load_baseline(BASELINE) == []
    assert baselined == [] and suppressed == []


def test_live_tick_is_captured():
    """The roots reach the port's real captured code: both engines' ticks
    (and what they call), the rules' step methods, the cache, the kernels'
    wrappers; the host references' loop is not captured."""
    index = build_index(load_modules([SRC], root=REPO))
    cap = {(fi.module.relpath.split("repro_torch/")[1], fi.qualname)
           for fi in index.traced_functions()}
    for want in [("core/scan_staleness.py", "_staleness_program.tick"),
                 ("core/scan_staleness.py", "_guard_payloads"),
                 ("core/scan_engine.py", "_scan_program.tick"),
                 ("core/scan_engine.py", "_payload_chain.payload"),
                 ("core/aggregators.py", "ACED.step_batch"),
                 ("core/aggregators.py", "ACED._sweep"),
                 ("core/cache.py", "BlockedFlatCache.set_row_delta"),
                 ("core/sanitize.py", "check_model_finite"),
                 ("kernels/ops.py", "quantize_rows"),
                 ("kernels/quant.py", "quantize_rows")]:
        assert want in cap, want
    assert ("core/staleness_sim.py", "StalenessSimulator.run") not in cap
    assert not any(q.endswith("nbytes") for p, q in cap
                   if p == "core/cache.py")


def test_baseline_round_trip(tmp_path, fixture_run):
    """write_baseline grandfathers every current finding; a rerun against
    that file reports them as baselined, not new."""
    new, _, _ = fixture_run
    bl = tmp_path / "baseline.json"
    write_baseline(str(bl), new)
    assert len(load_baseline(str(bl))) == len(new)
    new2, baselined2, _ = run_tracecheck([FIXTURES], root=FIXTURES,
                                         baseline=str(bl))
    assert new2 == []
    assert {f.key() for f in baselined2} == {f.key() for f in new}


@pytest.mark.parametrize("rule", sorted(RULES))
def test_rules_filter(rule):
    new, _, _ = run_tracecheck([FIXTURES], root=FIXTURES, rules=[rule])
    want = {x for x in _expected_markers() if x[2] == rule}
    assert {(f.path, f.line, f.rule) for f in new} == want


def test_syntax_error_is_a_finding_not_a_crash(tmp_path):
    (tmp_path / "broken.py").write_text("def oops(:\n")
    new, _, _ = run_tracecheck([str(tmp_path)], root=str(tmp_path))
    assert [(f.rule, f.path) for f in new] == [("TRC000", "broken.py")]


def _cli(*argv):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src") + os.pathsep + \
        env.get("PYTHONPATH", "")
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", *argv],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=120)


def test_cli_clean_on_repo_src_exit_0():
    """No paths: src/repro_torch under the root, with the root's baseline."""
    proc = _cli("--root", REPO)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "0 new" in proc.stdout


def test_cli_fixture_findings_exit_1_with_annotations():
    proc = _cli(FIXTURES, "--root", FIXTURES, "--github")
    assert proc.returncode == 1
    assert f"{N_MARKED} new" in proc.stdout
    assert "::error file=bad_rng.py" in proc.stdout
    assert "TRC004" in proc.stdout


def test_cli_usage_errors_exit_2():
    assert _cli(os.path.join(REPO, "no_such_dir")).returncode == 2
    assert _cli("--no-such-flag").returncode == 2


def test_cli_list_rules():
    proc = _cli("--list-rules")
    assert proc.returncode == 0
    for rid in RULES:
        assert rid in proc.stdout


def test_cli_summary_markdown(tmp_path):
    summary = tmp_path / "summary.md"
    proc = _cli(FIXTURES, "--root", FIXTURES, "--summary", str(summary))
    assert proc.returncode == 1
    text = summary.read_text()
    assert "## tracecheck" in text and f"| {N_MARKED} | 0 | 2 |" in text
    assert "TRC005" in text


def test_cli_write_baseline(tmp_path):
    bl = tmp_path / "bl.json"
    proc = _cli(FIXTURES, "--root", FIXTURES, "--write-baseline",
                "--baseline", str(bl))
    assert proc.returncode == 0 and len(load_baseline(str(bl))) == N_MARKED
    proc = _cli(FIXTURES, "--root", FIXTURES, "--baseline", str(bl))
    assert proc.returncode == 0
    assert f"0 new, {N_MARKED} baselined" in proc.stdout


def _imports(path):
    """Top-level package names a file imports (any depth of the AST)."""
    tree = ast.parse(open(path, encoding="utf-8").read(), filename=path)
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {al.name.split(".")[0] for al in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_port_imports_neither_repro_nor_jax():
    """The standing rule: no module of src/repro_torch, and not
    chip_smoke.py, imports `repro`, `repro.*` or `jax`."""
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(SRC):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 60
    bad = {os.path.relpath(f, REPO): sorted(_imports(f) & {"repro", "jax"})
           for f in files if _imports(f) & {"repro", "jax"}}
    assert bad == {}


def test_pinned_dtypes_hold_under_a_float64_default():
    """The TRC003 sites the analyzer found in core/ and the port now pins:
    under a float64 default dtype the MLP's and the text model's parameters,
    the text model's lane offsets, a runner's recorded models
    (``record_w``) and its eval snapshots (flat and tree, the tree run's
    init batch through the pinned client indices) stay float32, as the JAX
    package's are."""
    from repro_torch.core import aggregators as tagg
    from repro_torch.core import fl_tasks as ttasks
    from repro_torch.core.scan_staleness import (build_payload_noise,
                                                 build_staleness_randomness,
                                                 make_staleness_runner)
    torch.set_num_threads(1)
    n, d, E = 4, 3, 16
    grad = ttasks.ClientGrad(lambda w, c, z: (0.5 * (w ** 2).sum(-1),
                                              w + 0.1 * z), (d,), "normal")
    gtree = ttasks.ClientGrad(lambda w, c, z: (
        0.5 * (w["a"] ** 2).sum(-1), {"a": w["a"] + 0.1 * z}), (d,),
        "normal")
    rand = build_staleness_randomness(0, E, n, 2.0, device="cpu")
    noise = build_payload_noise(grad, 0, E, n, device="cpu")
    common = dict(n_clients=n, T=10, beta=2.0, eval_marks=(5, 10),
                  device="cpu")
    prev = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        mlp = ttasks.mlp_classifier((d, 5, 2))[0](
            torch.Generator().manual_seed(0), device="cpu")
        init, apply = ttasks.tiny_text_classifier(16, 4, 3, 5)
        text = init(torch.Generator().manual_seed(0), device="cpu")
        lanes = {k: v[None].expand((2,) + tuple(v.shape))
                 for k, v in text.items()}
        logits = apply(lanes, torch.zeros((2, 3, 5), dtype=torch.int64))
        flat = make_staleness_runner(
            grad_fn=grad, params0=torch.zeros(d),
            aggregator=tagg.ACEIncremental(), record_w=True, **common)
        _, _, outs, _ = flat(rand, noise, 0.1)
        tree = make_staleness_runner(
            grad_fn=gtree, params0={"a": torch.zeros(d)},
            aggregator=tagg.ACEIncremental(), layout="tree", **common)
        tw, _, _, _ = tree(rand, noise, 0.1)
    finally:
        torch.set_default_dtype(prev)
    got = [x.dtype for layer in mlp for x in layer.values()]
    got += [x.dtype for x in text.values()]
    got += [logits.dtype, outs["w"].dtype, flat.carry["snaps"].dtype,
            tree.carry["snaps"]["a"].dtype, tw["a"].dtype]
    assert got == [torch.float32] * len(got)
