"""TRC003 (dtype drift), TRC004 (sharding contract), TRC005 (cache keys).

These are *structural* contracts: unlike TRC001/TRC002 they mostly key off
a module's place and the code's shape rather than taint flow.

  * TRC003 pins the port's dtypes: buffers built in ``core/`` name their
    dtype, and captured arithmetic keeps to f32 literals;
  * TRC004 holds the blocked server state to its one source of splits:
    a cache, ring or snapshot buffer allocated under a mesh takes its split
    from `guarded_spec` (directly, through `MeshBlock`) or is a
    `BlockedFlatCache`;
  * TRC005 finds a memoised factory whose cache key misses one of its
    parameters.
"""
from __future__ import annotations

import ast
import struct
from typing import List, Set

from repro_torch.analysis.core import Finding
from repro_torch.analysis.traceinfo import FuncInfo, Index, iter_own

# -- TRC003: dtype drift -----------------------------------------------------

#: torch constructors that pick a dtype unless told one
_DTYPE_CTORS = {"zeros", "ones", "full", "empty", "arange", "tensor"}


def _beyond_f32(value: float) -> bool:
    """True when a float literal does not survive an f32 round trip and its
    author visibly asked for more digits than f32 keeps (more than 9
    significant ones), or it overflows f32."""
    if value == 0.0 or value != value:      # 0 / nan are representable
        return False
    try:
        rt = struct.unpack("<f", struct.pack("<f", value))[0]
    except (OverflowError, struct.error):
        return True                         # overflows f32 entirely
    if rt in (float("inf"), float("-inf")):
        return True
    if rt == value:
        return False
    digits = sum(c.isdigit() for c in repr(value).split("e")[0])
    return digits > 9


def check_dtype_drift(index: Index) -> List[Finding]:
    """TRC003. What it guards: the port matches the JAX package within 1e-5
    (f32) and bit for bit (int8 codes) only while every buffer has the dtype
    JAX's has. ``torch.full(shape, 0.5)`` takes the default dtype,
    ``torch.arange(n)`` int64 and ``torch.tensor(x)`` whatever `x` is — each
    a silent change of what a tick computes or of a kernel's operand type;
    the ``*_like`` constructors inherit theirs and are not flagged. A float
    literal with more digits than f32 keeps is rounded where it meets an
    f32 tensor, so the author's constant is not the one computed with."""
    out: List[Finding] = []
    for fi in index.traced_functions():
        tainted = index.tainted_names(fi)
        mod = fi.module
        for node in iter_own(fi.node):
            if not isinstance(node, ast.BinOp):
                continue
            for lit, other in ((node.left, node.right),
                               (node.right, node.left)):
                if isinstance(lit, ast.Constant) \
                        and isinstance(lit.value, float) \
                        and _beyond_f32(lit.value) \
                        and index.expr_tainted(fi, other, tainted):
                    out.append(mod.finding(
                        node, "TRC003",
                        f"float literal {lit.value!r} exceeds f32 in "
                        f"arithmetic with tensors in captured "
                        f"'{fi.qualname}' — it is silently rounded"))
    for mod in index.modules:
        if "/core/" not in f"/{mod.relpath}":
            continue
        for node in ast.walk(mod.tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in _DTYPE_CTORS):
                continue
            if index.module_path(mod, node.func) != \
                    f"torch.{node.func.attr}":
                continue
            if not any(k.arg == "dtype" for k in node.keywords):
                out.append(mod.finding(
                    node, "TRC003",
                    f"torch.{node.func.attr}(...) without dtype= in core/ "
                    f"— its dtype follows the default or the data, not "
                    f"the JAX package's"))
    return out


# -- TRC004: sharding contract -----------------------------------------------

_CONTRACT_MODULES = ("core/cache.py", "core/scan_sharded.py",
                     "core/distributed.py")
#: what makes a name a cache/ring/snapshot buffer
_BUFFER_WORDS = ("cache", "ring", "snap", "history", "buf", "store")
#: constructors that allocate a buffer
_ALLOCATORS = {"zeros", "ones", "full", "empty", "zeros_like", "ones_like",
               "full_like", "empty_like", "init_flat_cache",
               "init_tree_cache", "FlatCache"}
#: the sources of a blocked split (transitively: whatever calls them)
_SPLIT_SOURCES = {"guarded_spec", "BlockedFlatCache"}


def check_sharding_contract(index: Index) -> List[Finding]:
    """TRC004. What it guards: under a mesh the flat layout's server state
    lives in blocks — cache rows over ``data``, features over ``model`` —
    and every rank's collectives assume the split `guarded_spec` gives
    (`MeshBlock`, `BlockedFlatCache`). A cache, ring or snapshot buffer
    allocated under a mesh any other way is whole on every rank or split
    differently from the blocks its reads gather, and the all-reduce of the
    owners' rows sums the wrong rows. In the port `shard()` and
    `replicate()` hand their argument back unchanged, so unlike JAX's rule,
    passing a buffer through them proves nothing."""
    routes = _split_routes(index)
    out: List[Finding] = []
    for fi in index.funcs.values():
        rel = fi.module.relpath
        if not any(rel == m or rel.endswith("/" + m)
                   for m in _CONTRACT_MODULES):
            continue
        if fi.parent is not None:
            continue        # judged at the top-level function granularity
        if not (_mentions_mesh(fi) and _allocates_buffer(index, fi)):
            continue
        if id(fi.node) in routes:
            continue
        out.append(fi.module.finding(
            fi.node, "TRC004",
            f"'{fi.qualname}' allocates a cache/ring/snapshot buffer under "
            f"a mesh without taking its split from guarded_spec or "
            f"BlockedFlatCache (shard()/replicate() are identities here)"))
    return out


def _call_name(call: ast.Call) -> str:
    f = call.func
    return f.id if isinstance(f, ast.Name) else (
        f.attr if isinstance(f, ast.Attribute) else "")


def _split_routes(index: Index) -> Set[int]:
    """ids of the defs that take a split from a source: they call one, or a
    def (or construct a class whose ``__init__``) that does, by name."""
    names = set(_SPLIT_SOURCES)
    routed: Set[int] = set()
    changed = True
    while changed:
        changed = False
        for fi in index.funcs.values():
            if id(fi.node) in routed:
                continue
            if any(isinstance(n, ast.Call) and _call_name(n) in names
                   for n in ast.walk(fi.node)):
                routed.add(id(fi.node))
                names.add(fi.name)
                if fi.name == "__init__" and fi.cls is not None:
                    names.add(fi.cls.name)
                changed = True
    return routed


def _mentions_mesh(fi: FuncInfo) -> bool:
    """The function works under a mesh: it takes, reads or builds one."""
    for n in ast.walk(fi.node):
        name = n.id if isinstance(n, ast.Name) else (
            n.attr if isinstance(n, ast.Attribute) else (
                n.arg if isinstance(n, ast.arg) else ""))
        if "mesh" in name.lower():
            return True
    return False


def _is_buffery(name: str) -> bool:
    return any(w in name.lower() for w in _BUFFER_WORDS)


def _allocates_buffer(index: Index, fi: FuncInfo) -> bool:
    """An allocator call whose result lands in a buffer-named target, or any
    allocator call in a buffer-named function."""
    fn_buffery = _is_buffery(fi.name)
    for node in ast.walk(fi.node):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call) \
                and _call_name(node.value) in _ALLOCATORS:
            if fn_buffery or any(_is_buffery(n) for t in node.targets
                                 for n in _names(t)):
                return True
        elif isinstance(node, ast.Call) and fn_buffery \
                and _call_name(node) in _ALLOCATORS:
            return True
    return False


def _names(tgt: ast.AST) -> List[str]:
    out = []
    for n in ast.walk(tgt):
        if isinstance(n, ast.Name):
            out.append(n.id)
        elif isinstance(n, ast.Attribute):
            out.append(n.attr)
    return out


# -- TRC005: runner-cache-key completeness ----------------------------------

def check_cache_keys(index: Index) -> List[Finding]:
    """TRC005. What it guards: a memoised factory (a module-level
    ``*_CACHE`` dict) hands back the runner its key names; a parameter that
    changes what the runner computes (K, a layout, a mesh, a rule) but does
    not reach the key makes two different calls share one stale runner and
    its captured graph. Finds the module caches, the functions that index
    them, and checks that every parameter of each such function feeds the
    key."""
    out: List[Finding] = []
    for mod in index.modules:
        caches = _module_cache_names(mod)
        if not caches:
            continue
        for fi in index.funcs.values():
            if fi.module is not mod:
                continue
            key_exprs = _cache_key_exprs(fi, caches)
            if not key_exprs:
                continue
            fed = _names_feeding_key(fi, key_exprs)
            for p in fi.params():
                if p in fed:
                    continue
                line = key_exprs[0].lineno
                out.append(mod.finding(
                    line, "TRC005",
                    f"parameter '{p}' of '{fi.qualname}' never reaches its "
                    f"runner-cache key — two calls differing only in "
                    f"'{p}' would share a stale runner"))
    return out


def _module_cache_names(mod) -> Set[str]:
    names: Set[str] = set()
    for stmt in mod.tree.body:
        if isinstance(stmt, ast.Assign):
            targets, value = stmt.targets, stmt.value
        elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
            targets, value = [stmt.target], stmt.value
        else:
            continue
        if not (isinstance(value, (ast.Dict, ast.DictComp))
                or (isinstance(value, ast.Call)
                    and isinstance(value.func, ast.Name)
                    and value.func.id in ("dict", "OrderedDict"))):
            continue
        for t in targets:
            if isinstance(t, ast.Name) and "CACHE" in t.id.upper():
                names.add(t.id)
    return names


def _cache_key_exprs(fi: FuncInfo, caches: Set[str]) -> List[ast.AST]:
    """Expressions used to index/get/probe a module cache inside `fi`,
    resolved through one level of ``key = (...)`` indirection."""
    idx_exprs: List[ast.AST] = []
    for node in iter_own(fi.node):
        if isinstance(node, ast.Subscript) \
                and isinstance(node.value, ast.Name) \
                and node.value.id in caches:
            idx_exprs.append(node.slice)
        elif isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute) \
                and isinstance(node.func.value, ast.Name) \
                and node.func.value.id in caches \
                and node.func.attr in ("get", "setdefault", "pop") \
                and node.args:
            idx_exprs.append(node.args[0])
        elif isinstance(node, ast.Compare) \
                and any(isinstance(c, ast.Name) and c.id in caches
                        for c in node.comparators) \
                and any(isinstance(op, (ast.In, ast.NotIn))
                        for op in node.ops):
            idx_exprs.append(node.left)
    resolved: List[ast.AST] = []
    for e in idx_exprs:
        if isinstance(e, ast.Name):
            for stmt in iter_own(fi.node):
                if isinstance(stmt, ast.Assign) and any(
                        isinstance(t, ast.Name) and t.id == e.id
                        for t in stmt.targets):
                    resolved.append(stmt.value)
        else:
            resolved.append(e)
    return resolved


def _names_feeding_key(fi: FuncInfo, key_exprs: List[ast.AST]) -> Set[str]:
    """Names appearing in the key, closed over the function's assignments
    (``mesh_key = _mesh_shape(mesh)`` pulls in ``mesh``)."""
    fed: Set[str] = set()
    for e in key_exprs:
        for n in ast.walk(e):
            if isinstance(n, ast.Name):
                fed.add(n.id)
    for _ in range(10):
        before = len(fed)
        for stmt in iter_own(fi.node):
            if not isinstance(stmt, ast.Assign):
                continue
            tnames = {n.id for t in stmt.targets for n in ast.walk(t)
                      if isinstance(n, ast.Name)}
            if tnames & fed:
                for n in ast.walk(stmt.value):
                    if isinstance(n, ast.Name):
                        fed.add(n.id)
        if len(fed) == before:
            break
    return fed
