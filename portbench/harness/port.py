"""The program under test, the PyTorch and CUDA port in ``src/``: what the
benchmark takes of it (its entry points, launch counters and kernel
build), imported from the checkout the benchmark runs in."""
from __future__ import annotations

import dataclasses
import importlib
import sys
from pathlib import Path
from types import SimpleNamespace

PACKAGE = "repro_torch"


def load(root: Path) -> SimpleNamespace:
    """The port's modules; raises ImportError where the checkout has no
    port (a directory that holds only the benchmark)."""
    src = str(Path(root) / "src")
    if not (Path(src) / PACKAGE).is_dir():
        raise ImportError(f"no {PACKAGE} package under {src}")
    if src not in sys.path:
        sys.path.insert(0, src)
    names = dict(core=".core", scan=".core.scan_staleness",
                 engine=".core.scan_engine", sim=".core.staleness_sim",
                 ops=".kernels.ops", build=".kernels.build",
                 configs=".configs.base")
    return SimpleNamespace(**{k: importlib.import_module(PACKAGE + v)
                              for k, v in names.items()})


def model_config(port, cfg: dict):
    """The port's `ModelConfig` of a configuration file: every key of the
    file that is a field of it, stages as tuples."""
    fields = {f.name for f in dataclasses.fields(port.configs.ModelConfig)}
    kw = {k: v for k, v in cfg.items() if k in fields}
    kw["stages"] = tuple((tuple(p), int(r)) for p, r in cfg["stages"])
    return port.configs.ModelConfig(**kw)
