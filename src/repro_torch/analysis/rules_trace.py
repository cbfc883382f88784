"""TRC001 (host syncs in captured code) and TRC002 (RNG off the caller's
generator).

TRC001 fires only inside functions the index marks captured (run inside the
CUDA-graph tick): host drivers may call ``.item()`` on a finished run. TRC002
has two parts: a torch draw without ``generator=`` anywhere in the library,
and any draw at all in captured code. See `repro_torch.analysis.traceinfo`
for how "captured" and "a tensor" are inferred.
"""
from __future__ import annotations

import ast
from typing import List, Optional

from repro_torch.analysis.core import Finding
from repro_torch.analysis.traceinfo import FuncInfo, Index, iter_own

# -- TRC001: host syncs ------------------------------------------------------

#: builtins that copy a tensor's value to the host (a sync on the card; a
#: capture error, or a value the replay never updates, in a CUDA graph)
_SYNC_BUILTINS = {"float", "int", "bool", "complex"}
#: tensor methods that do the same
_SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}
#: ops whose output shape depends on the data (the host must read a count)
_DATA_SHAPED = {"nonzero", "masked_select", "unique", "unique_consecutive",
                "argwhere"}


def check_host_sync(index: Index) -> List[Finding]:
    """TRC001. What it guards: a captured tick replays the kernels it
    recorded and nothing else. A host read (``.item()``, ``float(t)``, a
    Python branch on a tensor) inside it either fails the capture or is
    taken once at capture time and never again, so the replayed graph
    silently diverges from the eager tick; an op whose output shape depends
    on the data reads a count on the host the same way."""
    out: List[Finding] = []
    for fi in index.traced_functions():
        tainted = index.tainted_names(fi)
        hosts = index.not_tensors(fi)
        mod = fi.module
        where = f"inside captured '{fi.qualname}'"
        for node in iter_own(fi.node):
            if isinstance(node, ast.Call):
                msg = _sync_call(index, fi, node,
                                 tainted - hosts.get(id(node), set()))
                if msg:
                    out.append(mod.finding(node, "TRC001", f"{msg} {where}"))
            elif isinstance(node, (ast.If, ast.While)) \
                    and index.expr_tainted(fi, node.test, tainted):
                kind = "if" if isinstance(node, ast.If) else "while"
                out.append(mod.finding(
                    node, "TRC001",
                    f"Python '{kind}' on a tensor {where} syncs with the "
                    f"host (use torch.where)"))
            elif isinstance(node, ast.Assert) \
                    and index.expr_tainted(fi, node.test, tainted):
                out.append(mod.finding(
                    node, "TRC001",
                    f"assert on a tensor {where} syncs with the host (use "
                    f"the sanitize checks' records)"))
    return out


def _sync_call(index: Index, fi: FuncInfo, node: ast.Call,
               tainted) -> Optional[str]:
    f = node.func
    mod = fi.module
    if isinstance(f, ast.Name):
        if f.id in _SYNC_BUILTINS and any(
                index.expr_tainted(fi, a, tainted) for a in node.args):
            return f"{f.id}() on a tensor forces a host sync"
        return None
    if not isinstance(f, ast.Attribute):
        return None
    dotted = index.module_path(mod, f)
    if dotted is not None:
        name = dotted.rsplit(".", 1)[1]
        if dotted.startswith("torch.") and name in _DATA_SHAPED:
            return (f"torch.{name}() has a data-dependent shape and reads "
                    f"its size on the host")
        if dotted.startswith("torch.") and name == "where" \
                and len(node.args) == 1 and not node.keywords:
            return ("torch.where(cond) is nonzero: a data-dependent shape "
                    "read on the host")
        if dotted in ("numpy.asarray", "numpy.array") and any(
                index.expr_tainted(fi, a, tainted) for a in node.args):
            return f"np.{name}() on a tensor copies it to the host"
        return None
    if not index.expr_tainted(fi, f.value, tainted):
        return None
    if f.attr in _SYNC_METHODS:
        return f".{f.attr}() on a tensor forces a host sync"
    if f.attr in _DATA_SHAPED:
        return (f".{f.attr}() has a data-dependent shape and reads its "
                f"size on the host")
    return None


# -- TRC002: RNG -------------------------------------------------------------

#: torch functions that draw from an RNG (they take ``generator=``)
_TORCH_DRAWS = {"rand", "randn", "randint", "randperm", "normal",
                "bernoulli", "multinomial", "poisson", "rand_like",
                "randn_like", "randint_like"}
#: in-place tensor methods that draw
_INPLACE_DRAWS = {"uniform_", "normal_", "exponential_", "random_",
                  "bernoulli_", "geometric_", "cauchy_", "log_normal_"}


def check_rng(index: Index) -> List[Finding]:
    """TRC002. What it guards: the port's RNG contract. Every stream an
    entry point draws (gumbels, Exp(β) staleness, payload noise, fault
    schedules, weights) comes from a `torch.Generator` the caller seeded, so
    a run is a function of its seed and the tests can replay JAX's streams
    in its place; a draw from the global generator breaks both. Inside the
    captured tick no draw belongs at all: the tick reads only the streams
    drawn before it, and a draw recorded in a graph replays the same
    numbers, or the generator's offset, not the eager tick's.

    JAX's key-reuse sub-rule has no counterpart: a `torch.Generator` is
    stateful, every draw advances it, so two draws from one generator never
    see the same numbers."""
    out: List[Finding] = []
    captured = {id(fi.node): fi for fi in index.traced_functions()}
    for mod in index.modules:
        for node in ast.walk(mod.tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)):
                continue
            what = _draw(index, mod, node)
            if what is None:
                continue
            fi = _owner(index, mod, node, captured)
            if fi is not None:
                out.append(mod.finding(
                    node, "TRC002",
                    f"{what} inside captured '{fi.qualname}' — the tick "
                    f"reads only the streams drawn before it"))
            elif what.startswith("torch") and not any(
                    k.arg == "generator" for k in node.keywords):
                out.append(mod.finding(
                    node, "TRC002",
                    f"{what} without generator= draws from the global "
                    f"generator — take a torch.Generator seeded by the "
                    f"caller"))
    return out


def _draw(index: Index, mod, node: ast.Call) -> Optional[str]:
    """A description of the random draw `node` makes, else None."""
    f = node.func
    dotted = index.module_path(mod, f)
    if dotted is not None:
        name = dotted.rsplit(".", 1)[1]
        if dotted.startswith("torch.nn.init.") or (
                dotted.startswith("torch.") and name in _TORCH_DRAWS):
            return f"{dotted}()"
        if dotted.startswith("numpy.random."):
            return f"np.random.{name}()"
        if dotted.startswith("random."):
            return f"random.{name}()"
        return None
    if f.attr in _INPLACE_DRAWS:
        return f"torch .{f.attr}()"
    return None


def _owner(index: Index, mod, node, captured) -> Optional[FuncInfo]:
    """The captured function whose own body holds `node`, else None."""
    for fi in captured.values():
        if fi.module is mod and any(n is node for n in iter_own(fi.node)):
            return fi
    return None
