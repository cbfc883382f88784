"""The port's boundary and its front door, on the CPU:

  * no module of `src/repro_torch/`, no `examples/torch_*.py` and not
    `chip_smoke.py` imports `jax` or the JAX package `repro` (parsed, not
    imported);
  * each `examples/torch_*.py` runs through its ``main(device="cpu")`` and
    prints its JAX twin's lines — the quickstart with exactly 319 and 300
    client uploads, the counts of `examples/quickstart.py`, since both
    packages draw the protocol from ``np.random.default_rng(seed)``; the
    serving example serves its three reduced archs, and the train example
    runs the train driver (a few steps here).
"""
import ast
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted([*(ROOT / "src" / "repro_torch").rglob("*.py"),
                     *(ROOT / "examples").glob("torch_*.py"),
                     ROOT / "chip_smoke.py"])


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small CPU ops are slow with many intra-op threads on a shared host;
    the examples' models are small."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _imports(path):
    """Every module name `path` imports, at any depth of its code."""
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_the_port_imports_neither_jax_nor_the_jax_package():
    assert len(PORT_FILES) > 20 and ROOT / "chip_smoke.py" in PORT_FILES
    bad = [(p.relative_to(ROOT).as_posix(), name)
           for p in PORT_FILES for name in _imports(p)
           if name.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad


def _main(name):
    path = ROOT / "examples" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"_example_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.main


def test_quickstart_prints_its_lines_and_counts(capsys):
    results = _main("torch_quickstart")(device="cpu")
    lines = capsys.readouterr().out.splitlines()
    assert [line[:13] for line in lines] == ["ACE          ",
                                             "Vanilla ASGD "]
    assert "(319 client uploads)" in lines[0]
    assert "(300 client uploads)" in lines[1]
    for sim, r in results.values():
        assert torch.isfinite(sim.w).all()
        assert r.eval_ts == [100, 200, 300]
        assert r.evals[-1]["accuracy"] > 0.5          # chance is 0.1
    assert [r.total_comms for _, r in results.values()] == [319, 300]


def test_heterogeneity_prints_its_table(capsys):
    errors = _main("torch_afl_heterogeneity")(device="cpu")
    out = capsys.readouterr().out.splitlines()
    assert out[0].split() == ["algo", "zeta", "beta", "steady-state",
                              "error"]
    assert len([line for line in out if line.strip()]) == 13
    for beta in (2, 20):
        # ACE's floor does not grow with the heterogeneity; ASGD's does
        assert errors["ace", 4.0, beta] == pytest.approx(
            errors["ace", 0.5, beta], rel=1e-2)
        assert errors["asgd", 4.0, beta] > 2 * errors["asgd", 0.5, beta]


def test_aced_dropout_prints_its_table(capsys):
    accs = _main("torch_aced_dropout")(device="cpu")
    out = capsys.readouterr().out.splitlines()
    assert out[0].split() == ["algo", "dropout", "final", "acc"]
    assert sum("tau_algo=" in line for line in out) == 4
    assert len(accs) == 10
    assert all(0.1 < a <= 1.0 for a in accs.values())


def test_serve_batch_serves_three_archs(capsys):
    out = _main("torch_serve_batch")(device="cpu")
    lines = capsys.readouterr().out.splitlines()
    archs = ("gemma2-2b", "minicpm3-4b", "mamba2-780m")
    assert [line for line in lines if line.startswith("===")] == \
        [f"=== {a} (reduced) ===" for a in archs]
    assert sum(line.startswith("sample token ids:") for line in lines) == 3
    assert list(out) == list(archs)
    for gen in out.values():
        assert gen.shape == (2, 16) and (gen >= 0).all()


def test_train_lm_runs_the_train_driver(capsys):
    """A short run of the example's reduced yi model (its default is 300
    steps, minutes on the CPU): the driver's lines, a finite loss below
    ln(512) + 0.5."""
    final = _main("torch_train_lm")(device="cpu", steps=6)
    out = capsys.readouterr().out
    assert out.startswith("model=yi-9b-reduced")
    assert "final loss (mean last 20)" in out
    assert np.isfinite(final) and final < np.log(512) + 0.5
