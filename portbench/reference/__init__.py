"""Plain PyTorch references of what the benchmark's cells run, each found
by the name its configuration or mix gives: the model (a configuration's
``"reference"``: `<name>.py`'s `Model`), the server protocol (a mix's
``"protocol"``: `protocol_<name>.py`'s `run`), the rule (a mix's
``"rule"``: `rule_<name>.py`'s `Rule`) and the task (a mix's ``"task"``:
`task_<name>.py`'s `Task`). Nothing here imports the program."""
from __future__ import annotations

import importlib


def _module(name: str):
    return importlib.import_module(f"{__name__}.{name}")


def model(cfg: dict, precision: str = "float32"):
    """The plain model of configuration `cfg`: ``shapes()`` (path ->
    shape) and ``grad(params, names, inputs, targets)``."""
    return _module(cfg["reference"]).Model(cfg, precision)


def shapes(cfg: dict):
    """The parameters configuration `cfg` has: path -> shape."""
    return model(cfg).shapes()


def protocol(mix: dict):
    return _module(f"protocol_{mix['protocol']}")


def rule(mix: dict):
    return _module(f"rule_{mix['rule']}").Rule


def task(mix: dict):
    return _module(f"task_{mix['task']}").Task
