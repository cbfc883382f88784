"""The harness's pieces on the CPU: finding a cell's files by name, the
frozen operation and byte counts, the trace reader and its retake rule,
the metric readers, and the import rules of the benchmark's sources."""
import ast
import importlib
import json
import shutil
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from portbench_testlib import BENCH, REPO
from harness import cell, flops, trace

FORBIDDEN = {"jax", "jaxlib", "repro"}


def _bench():
    return json.loads((REPO / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("workload", [w["name"] for w in _bench()["workloads"]])
def test_cell_files_found_by_name(workload):
    spec = cell.load_spec(workload, REPO)
    assert spec.cfg["name"] == spec.cell["config"]
    assert spec.mix["name"] == spec.cell["traffic"]
    assert {m["name"] for m in spec.end_to_end} >= {"setup_s"}
    for m in spec.per_layer:
        assert callable(importlib.import_module(f"metrics.{m['name']}").read)


def test_new_files_and_entries_need_no_edit(tmp_path, monkeypatch):
    """A configuration with a plain model of its own, a mix with its own
    protocol and a per-layer metric, added as new files and new entries,
    are found by name, with no edit to an existing file."""
    root = tmp_path
    shutil.copytree(BENCH / "configs", root / "portbench" / "configs")
    shutil.copytree(BENCH / "mixes", root / "portbench" / "mixes")
    cfg = json.loads((BENCH / "configs/mamba2-780m.json").read_text())
    cfg.update(name="toy", reference="toy_plain")
    (root / "portbench/configs/toy.json").write_text(json.dumps(cfg))
    mix = json.loads((BENCH / "mixes/ace-int8-k1.b8.json").read_text())
    mix.update(name="ace-int8-k3.b1", batch=1, k_batch=3, protocol="cohort")
    (root / "portbench/mixes/ace-int8-k3.b1.json").write_text(json.dumps(mix))
    new = tmp_path / "new"
    new.mkdir()
    (new / "calls_traced.py").write_text("def read(run):\n"
                                         "    return run.calls\n")
    (new / "toy_plain.py").write_text(
        "class Model:\n"
        "    def __init__(self, cfg, precision):\n"
        "        self.d = cfg['d_model']\n"
        "    def shapes(self):\n"
        "        return {'w': (self.d, 3)}\n")
    (new / "protocol_cohort.py").write_text("def run(**kw):\n"
                                            "    return 'cohort'\n")
    import metrics
    import reference
    monkeypatch.setattr(metrics, "__path__",
                        list(metrics.__path__) + [str(new)])
    monkeypatch.setattr(reference, "__path__",
                        list(reference.__path__) + [str(new)])
    new_cell = "toy.ace-int8-k3.b1"
    bench = _bench()
    bench["configs"].append({"name": "toy", "source": "x",
                             "file": "portbench/configs/toy.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": new_cell, "config": "toy",
                               "traffic": "ace-int8-k3.b1", "chips": 1,
                               "why": "x"})
    bench["per_layer"].append({"name": "calls_traced", "unit": "calls",
                               "better": "lower", "source": "device_trace",
                               "layer": "x", "moves": "arrivals_per_s",
                               "workloads": [new_cell]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    spec = cell.load_spec(new_cell, root)
    assert spec.mix["batch"] == 1 and spec.cfg["name"] == "toy"
    assert spec.limits == {}
    assert [m["name"] for m in spec.per_layer] == ["calls_traced"]
    assert reference.shapes(spec.cfg) == {"w": (1536, 3)}
    assert reference.protocol(spec.mix).run() == "cohort"
    assert reference.rule(spec.mix) is reference.rule(
        json.loads((BENCH / "mixes/ace-int8-k1.b8.json").read_text()))
    reader = importlib.import_module("metrics.calls_traced")
    assert reader.read(SimpleNamespace(calls=2)) == 2
    other = cell.load_spec(_bench()["workloads"][0]["name"], root)
    assert "calls_traced" not in [m["name"] for m in other.per_layer]


def _registry_cut(name, stages):
    """A port registry configuration cut to `stages`, as a file's dict."""
    import dataclasses
    from repro_torch.configs.registry import get_config
    cfg = dataclasses.replace(get_config(name), stages=stages,
                              num_layers=sum(len(p) * r for p, r in stages))
    return cfg, dataclasses.asdict(cfg)


@pytest.mark.parametrize("name,stages,total", [
    ("yi-9b", (((("attn",), 1),)), 5.3603e12),
    ("zamba2-1.2b", ((("mamba",) * 5 + ("shared_attn",), 1),
                     (("mamba",), 1)), 2.8409e12)])
def test_frozen_flops_match_the_analytic_count(name, stages, total):
    from repro_torch.launch.analytic import forward_flops
    port_cfg, cfg = _registry_cut(name, stages)
    ours = flops.forward_flops(cfg, 8, 256)
    assert ours == forward_flops(port_cfg, 8, 256)
    assert 3 * ours == pytest.approx(total, rel=1e-4)
    tied = 2 * cfg["vocab_size"] * cfg["d_model"] * 8 * 256
    assert flops.unembed_flops(cfg, 8, 256) == (tied if cfg["tie_embeddings"]
                                                else 0)
    assert flops.gradient_flops(cfg, 8, 256) == 3 * (
        ours + flops.unembed_flops(cfg, 8, 256))


@pytest.mark.parametrize("name", [c["name"] for c in _bench()["configs"]])
def test_frozen_flops_of_each_configuration_file(name):
    """Each file's count equals the port's analytic count of the same
    configuration, and the reference's parameters are those the file
    expects."""
    import math
    import reference
    from harness import port as port_mod
    from repro_torch.launch.analytic import forward_flops
    cfg = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    port_cfg = port_mod.model_config(port_mod.load(REPO), cfg)
    assert flops.forward_flops(cfg, 8, 256) == forward_flops(port_cfg, 8, 256)
    shapes = reference.shapes(cfg)
    assert {"leaves": len(shapes),
            "numel": sum(math.prod(s) for s in shapes.values())} \
        == cfg["expect"]


def test_quant_bytes_and_roofline_reader():
    assert flops.quant_bytes(262144000) == 5 * 262144000 + 4
    assert flops.dequant_bytes(10, rows=3) == 3 * 54
    reader = importlib.import_module("metrics.quant_roofline")
    bound = 1e3 * flops.quant_bytes(1000) / flops.HBM_BYTES_PER_S
    run = SimpleNamespace(quant=[("quantize_rows", 1000, 2 * bound, bound),
                                 ("dequantize_rows", 1000, 2 * bound, bound)])
    assert reader.read(run) == pytest.approx(50.0)
    assert reader.read(SimpleNamespace(quant=[])) is None


def _record(rows, intervals, wall, host=()):
    rec = trace.Record()
    rec.rows, rec.intervals, rec.wall_s = rows, intervals, wall
    rec.host = list(host)
    return rec


def test_trace_union_gaps_and_symbols():
    assert trace.busy_seconds([(0, 10), (5, 20), (30, 40)]) == 30e-9
    assert trace.symbol_matches(trace.KERNEL_SYMBOLS["quantize_rows"],
                                "void quantize_rows_grid_kernel<4>(float)")
    assert not trace.symbol_matches(trace.KERNEL_SYMBOLS["quantize_rows"],
                                    "dequantize_rows_kernel")
    rec = _record({}, [(0, 100), (200_000, 200_100), (200_200, 200_300)], 1,
                  host=[(0, 300_000, "runner call"), (100, 150_000, "init")])
    gaps = dict(trace.idle_gaps(rec))
    assert gaps["init"] == pytest.approx((200_000 - 100) / 1e9)
    assert gaps[f"gaps under {trace.SHORT_GAP_NS / 1000:g} us between "
                "device operations"] == pytest.approx(100e-9)


def test_traced_call_retakes_a_trace_that_lost_launches(monkeypatch):
    import contextlib
    seen = iter([{"quantize_rows_kernel": [3, 1e-3]},
                 {"quantize_rows_kernel": [4, 1e-3]}])
    monkeypatch.setattr(torch.profiler, "profile",
                        lambda **kw: contextlib.nullcontext(None))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(trace, "read_trace",
                        lambda prof: _record(next(seen), [], 0.0))
    counts = {k: 0 for k in trace.KERNEL_SYMBOLS}
    counts["quantize_rows"] = 4
    lines = []
    rec, out = trace.traced_call(lambda: "done", lambda: None,
                                 lambda: dict(counts), lines.append)
    assert out == "done" and len(lines) == 1
    assert rec.rows["quantize_rows_kernel"][0] == 4
    monkeypatch.setattr(trace, "read_trace",
                        lambda prof: _record({}, [], 0.0))
    with pytest.raises(RuntimeError, match="every one of 3 traces"):
        trace.traced_call(lambda: None, lambda: None, lambda: dict(counts),
                          lines.append)


def test_metric_readers_on_a_record():
    rows = {"ampere_sgemm_128x64": [10, 0.05],
            "void quantize_rows_kernel<2>": [20, 0.002],
            "elementwise_kernel": [70, 0.01]}
    rec = _record(rows, [(0, int(0.062e9))], 0.1)
    run = SimpleNamespace(record=rec, ticks=10, calls=1, wall_s=0.1,
                          gradients=18, gradient_flops=1e11, quant=[])

    def read(name):
        return importlib.import_module(f"metrics.{name}").read(run)
    assert read("kernels_per_tick") == 10
    assert read("gemm_ms_per_tick") == pytest.approx(5.0)
    assert read("port_kernel_ms_per_tick") == pytest.approx(0.2)
    assert read("device_idle_share") == pytest.approx(38.0)
    assert read("mfu") == pytest.approx(100 * 18e11 / 0.1 / 67e12)
    assert read("quant_roofline") is None


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", None) == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


def _sources():
    return sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts)


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_or_jax_package_import(path):
    """Every module's top-level name compared whole: ``repro_torch`` is the
    port, not the JAX package ``repro``."""
    tops = {m.split(".")[0] for m in _imports(path)}
    assert not tops & FORBIDDEN, tops & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    tops = {m.split(".")[0] for m in _imports(path)}
    assert tops <= {"__future__", "importlib", "math", "typing", "numpy",
                    "torch", "reference"}, tops


def test_top_level_names_compared_whole(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import repro_torch.core\nfrom jaxlib import x\n"
                   "importlib.import_module('repro.core')\n")
    tops = {m.split(".")[0] for m in _imports(src)}
    assert tops & FORBIDDEN == {"jaxlib", "repro"}


def test_run_refuses_a_machine_without_cuda(monkeypatch, capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    sys.path.insert(0, str(BENCH))
    run = importlib.import_module("run")
    rc = run.main(["--workload", _bench()["workloads"][0]["name"], "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""
