"""Capture inference shared by every tracecheck rule of the port.

Answers two questions about the scanned code, from the ASTs alone:

  1. **Which functions are captured** — run inside the CUDA-graph tick,
     where a host sync breaks the capture (or silently reads a value the
     replay never updates) and a random draw is recorded once and replayed
     unchanged? Roots:
       (a) the ``tick`` bodies handed to a program (a function passed as
           ``tick=`` to any call: `_Program`, `_StalenessProgram`);
       (b) anything called inside a ``with torch.cuda.graph(...)`` block —
           a bare name resolves like any call, ``obj.name(...)`` to every
           function (not method) called ``name`` in the scanned code;
       (c) the ``init_state``/``step``/``step_batch``/``resync`` methods of
           `Aggregator` subclasses;
       (d) every def in ``core/cache.py`` (but the ``*nbytes`` helpers) and
           in ``kernels/``.
     The set then closes over calls: a function called by a captured one
     is captured — through enclosing-scope aliases (``rd = ring_read``),
     factory results (``payload_fn = _payload_chain(...)``, which returns
     a nested def), ``module.func(...)`` on an imported module and
     ``self.method(...)`` inside a class — and nested defs of a captured
     function are captured.

  2. **Which values inside a captured function are tensors?** Seeds are
     the results of ``torch.*`` calls (but host queries: ``torch.device``,
     ``torch.finfo``, ``torch.cuda.*``, ...), and the function's parameters
     that its body feeds to torch: passed bare to a ``torch.*`` call, or
     the receiver of a tensor method (``x.index_select(...)``). For a tick
     body, a graph-block callee and an Aggregator ``step``/``step_batch``/
     ``resync`` every parameter but the static ones is a seed. Taint flows
     through assignments, arithmetic, subscripts, method calls, unknown
     calls, loops and comprehensions; the host metadata ``.shape``,
     ``.dtype``, ``.device``, ``.numel()``, ``.dim()``, ``len()``,
     ``isinstance()``, ``x is None`` and ``"key" in d`` break it.

A function reached only through a parameter (the task's ``grad_fn`` the
tick calls) is not seen. Both are heuristics tuned to the port's idioms. They are held against the
fixture corpus (tests/torch_analysis_fixtures/), and the live package must
scan clean, so drift either way shows.
"""
from __future__ import annotations

import ast
import dataclasses
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.analysis.core import SourceModule

#: module roots the index tracks through imports
_TRACKED_ROOTS = ("torch", "numpy", "random")
#: torch calls that answer host questions (never tensors)
_STATIC_TORCH_CALLS = {
    "device", "finfo", "iinfo", "is_tensor", "is_floating_point",
    "is_complex", "promote_types", "result_type", "can_cast",
    "get_default_dtype", "Size", "Generator", "no_grad", "enable_grad",
    "inference_mode", "is_grad_enabled", "get_num_threads",
    "set_num_threads", "typename", "numel", "dtype", "manual_seed",
}
#: torch submodules whose calls are host work (streams, graphs, groups)
_STATIC_TORCH_PREFIXES = ("torch.cuda.", "torch.backends.",
                          "torch.distributed.", "torch.profiler.",
                          "torch.utils.")
#: attribute reads that return host metadata, never tensors
_STATIC_ATTRS = {"shape", "ndim", "dtype", "device", "is_cuda", "layout",
                 "requires_grad", "is_leaf", "itemsize", "nbytes", "names",
                 "type"}
#: tensor methods that return host metadata
_STATIC_METHODS = {"size", "dim", "ndimension", "numel", "nelement",
                   "stride", "element_size", "is_contiguous", "data_ptr",
                   "storage_offset", "get_device", "is_floating_point",
                   "is_complex", "is_pinned", "untyped_storage"}
#: builtins whose result is host structure, whatever they are given
_STATIC_BUILTINS = {"len", "isinstance", "range", "type", "id", "repr",
                    "getattr", "hasattr", "print", "callable", "str",
                    "issubclass", "sorted"}
#: methods that mark their receiver as a tensor (a parameter used so is a
#: seed of the function's taint)
_TENSOR_METHODS = {
    "index_select", "index_copy_", "index_add_", "index_fill_", "copy_",
    "zero_", "fill_", "clamp", "clamp_", "clamp_min", "clamp_max",
    "float", "half", "bfloat16", "int", "long", "bool", "to", "view",
    "reshape", "flatten", "unsqueeze", "squeeze", "expand", "expand_as",
    "repeat", "contiguous", "clone", "detach", "sum", "mean", "amax",
    "amin", "max", "min", "abs", "sqrt", "square", "any", "all", "argmax",
    "argmin", "gather", "scatter", "scatter_", "scatter_add_", "masked_fill",
    "masked_fill_", "where", "mul", "mul_", "add", "add_", "sub", "sub_",
    "div", "div_", "neg", "exp", "log", "pow", "matmul", "mm", "t",
    "transpose", "permute", "narrow", "split", "chunk", "unbind", "roll",
    "cumsum", "sort", "topk", "isfinite", "isnan", "eq", "ne", "lt", "le",
    "gt", "ge", "logical_and", "logical_or", "logical_not", "select",
    "new_zeros", "new_full", "new_empty", "new_ones", "type_as", "norm",
    "item", "tolist", "cpu", "cuda", "numpy", "nonzero", "masked_select",
    "unique",
}
#: parameter names that are host configuration by the port's convention
_STATIC_PARAM_NAMES = {"dtype", "shape", "axis", "axes", "layout", "mesh",
                       "cfg", "config", "self", "cls", "device", "backend",
                       "plan", "name", "names"}
#: annotation substrings that mark a parameter as a tensor
_ARRAY_ANN = ("Tensor", "PyTree")
#: annotation substrings that mark a parameter as host configuration
_STATIC_ANN = ("bool", "int", "str", "float", "Config", "Literal",
               "Callable", "Schedule", "None", "device", "dtype")

#: type names a host-valued return annotation is made of (a call of a
#: scanned def so annotated, or a read of a property so annotated, gives a
#: host value whatever it is handed)
_HOST_TYPES = ("Optional", "Tuple", "tuple", "List", "list", "Dict", "dict",
               "bool", "int", "float", "str", "None", "device", "dtype")
#: calls whose result is a host value: the sync happened (and is reported)
#: at the call itself
_SYNC_RESULTS = {"float", "int", "bool", "complex"}
_SYNC_RESULT_METHODS = {"item", "tolist", "cpu", "numpy"}

#: captured surfaces by module (path suffix -> def names left out)
_CAPTURED_MODULES = {"core/cache.py": ("nbytes",), "kernels/": ()}
_AGG_METHODS = {"init_state", "step", "step_batch", "resync"}
#: Aggregator methods whose every parameter is a tensor (or a tuple of them)
_AGG_SEEDED = {"step", "step_batch", "resync"}


@dataclasses.dataclass
class FuncInfo:
    node: ast.AST                       # FunctionDef / AsyncFunctionDef
    module: SourceModule
    qualname: str
    parent: Optional["FuncInfo"] = None
    cls: Optional[ast.ClassDef] = None  # the class a method is defined in
    traced: bool = False                # captured (the JAX index's name)
    traced_via: str = ""                # why (debugging / messages)
    #: every non-static parameter is a tensor by contract (tick bodies,
    #: graph-block callees, Aggregator step/step_batch/resync)
    seed_params: bool = False

    @property
    def name(self) -> str:
        return self.node.name

    def params(self) -> List[str]:
        a = self.node.args
        names = [p.arg for p in a.posonlyargs + a.args + a.kwonlyargs]
        return [n for n in names if n not in ("self", "cls")]

    def tracer_params(self) -> List[str]:
        """Parameters that can hold tensors: drops the conventionally
        static names and the statically annotated ones."""
        a = self.node.args
        out = []
        for p in a.posonlyargs + a.args + a.kwonlyargs:
            if p.arg in _STATIC_PARAM_NAMES:
                continue
            if p.annotation is not None and _static_annotation(p.annotation):
                continue
            out.append(p.arg)
        return out


class Index:
    """Cross-module function/alias index + captured marking + taint."""

    def __init__(self, modules: List[SourceModule]):
        self.modules = modules
        self.funcs: Dict[int, FuncInfo] = {}          # id(node) -> info
        #: per module: top-level def name -> FuncInfo
        self.top: Dict[str, Dict[str, FuncInfo]] = {}
        #: per module: import alias -> dotted module name ("np" -> "numpy")
        self.mod_alias: Dict[str, Dict[str, str]] = {}
        #: per module: name -> (source module, original name) for
        #: ``from X import y [as z]``
        self.from_imports: Dict[str, Dict[str, Tuple[str, str]]] = {}
        #: dotted module name -> SourceModule (best effort)
        self.by_dotted: Dict[str, SourceModule] = {}
        #: def name -> every FuncInfo of that name
        self.by_name: Dict[str, List[FuncInfo]] = {}
        self._taint_cache: Dict[int, Set[str]] = {}
        for m in modules:
            self._index_module(m)
        #: properties annotated to return host values (``cache.quantized``)
        self.host_props: Set[str] = {
            fi.name for fi in self.funcs.values()
            if fi.cls is not None and _host_annotation(fi.node.returns)
            and any(isinstance(d, ast.Name) and d.id == "property"
                    for d in fi.node.decorator_list)}
        self._mark_traced()

    # -- construction -------------------------------------------------------

    def _dotted_name(self, mod: SourceModule) -> str:
        parts = mod.relpath[:-3].split("/")
        if "src" in parts:
            parts = parts[parts.index("src") + 1:]
        if parts and parts[-1] == "__init__":
            parts = parts[:-1]
        return ".".join(parts)

    def _index_module(self, mod: SourceModule) -> None:
        key = mod.relpath
        self.top[key] = {}
        self.mod_alias[key] = {}
        self.from_imports[key] = {}
        self.by_dotted[self._dotted_name(mod)] = mod

        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Import):
                for al in node.names:
                    if al.asname:
                        self.mod_alias[key][al.asname] = al.name
                    else:       # import torch.nn.functional binds `torch`
                        root = al.name.split(".")[0]
                        self.mod_alias[key][root] = root
            elif isinstance(node, ast.ImportFrom) and node.module:
                for al in node.names:
                    self.from_imports[key][al.asname or al.name] = (
                        node.module, al.name)

        def visit(node, parent_fi, prefix, cls):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    fi = FuncInfo(child, mod, f"{prefix}{child.name}",
                                  parent=parent_fi, cls=cls)
                    self.funcs[id(child)] = fi
                    self.by_name.setdefault(child.name, []).append(fi)
                    if parent_fi is None and isinstance(node, ast.Module):
                        self.top[key][child.name] = fi
                    visit(child, fi, f"{prefix}{child.name}.", None)
                elif isinstance(child, ast.ClassDef):
                    visit(child, parent_fi, f"{prefix}{child.name}.", child)
                else:
                    visit(child, parent_fi, prefix, cls)
        visit(mod.tree, None, "", None)

    # -- name / call resolution ---------------------------------------------

    def module_path(self, mod: SourceModule, expr: ast.AST) -> Optional[str]:
        """Dotted name of `expr` when it is (an attribute path rooted at) an
        imported torch, numpy or random module, else None:
        ``F.softmax`` -> ``torch.nn.functional.softmax``."""
        parts = []
        while isinstance(expr, ast.Attribute):
            parts.append(expr.attr)
            expr = expr.value
        if not isinstance(expr, ast.Name):
            return None
        base = self.mod_alias[mod.relpath].get(expr.id)
        if base is None:
            imp = self.from_imports[mod.relpath].get(expr.id)
            if imp is not None:         # from torch.nn import functional
                base = f"{imp[0]}.{imp[1]}"
        if base is None:
            return None
        dotted = ".".join([base] + list(reversed(parts)))
        if any(dotted == r or dotted.startswith(r + ".")
               for r in _TRACKED_ROOTS):
            return dotted
        return None

    def torch_op(self, mod: SourceModule, call: ast.Call) -> Optional[str]:
        """The dotted name of a ``torch.*`` call, else None."""
        d = self.module_path(mod, call.func)
        return d if d is not None and d.startswith("torch.") else None

    def is_tensor_call(self, mod: SourceModule, call: ast.Call) -> bool:
        """A torch call whose result is a tensor (not a host query)."""
        d = self.torch_op(mod, call)
        if d is None:
            return False
        return (d.rsplit(".", 1)[1] not in _STATIC_TORCH_CALLS
                and not d.startswith(_STATIC_TORCH_PREFIXES))

    def resolve_name(self, mod: SourceModule, fi: Optional[FuncInfo],
                     name: str) -> List[FuncInfo]:
        """Resolve a called identifier to candidate FuncInfos:
        enclosing-scope nested defs and aliases, module top-level defs,
        then ``from``-imports from other scanned modules."""
        out: List[FuncInfo] = []
        scope = fi
        while scope is not None:
            for child in ast.walk(scope.node):
                if isinstance(child, (ast.FunctionDef,
                                      ast.AsyncFunctionDef)) \
                        and child.name == name and id(child) in self.funcs:
                    out.append(self.funcs[id(child)])
            out += self._resolve_assigned(mod, scope.node, name)
            scope = scope.parent
        if name in self.top[mod.relpath]:
            out.append(self.top[mod.relpath][name])
        imp = self.from_imports[mod.relpath].get(name)
        if imp is not None:
            src = self.by_dotted.get(imp[0])
            if src is not None and imp[1] in self.top[src.relpath]:
                out.append(self.top[src.relpath][imp[1]])
        return out

    def _resolve_assigned(self, mod: SourceModule, scope_node: ast.AST,
                          name: str) -> List[FuncInfo]:
        """``name = other`` and ``name = factory(...)`` (tuple forms too):
        the aliased def, or the def(s) a factory returns."""
        out: List[FuncInfo] = []
        for stmt in ast.walk(scope_node):
            if not isinstance(stmt, ast.Assign):
                continue
            for tgt, val in _assign_pairs(stmt):
                names = {n.id for n in ast.walk(tgt)
                         if isinstance(n, ast.Name)}
                if name not in names:
                    continue
                if isinstance(val, ast.Name) and isinstance(tgt, ast.Name) \
                        and val.id != name:
                    out += self.resolve_name(mod, self.funcs.get(
                        id(scope_node)), val.id)
                elif isinstance(val, ast.Call) \
                        and isinstance(val.func, ast.Name):
                    for factory in self.resolve_name(
                            mod, self.funcs.get(id(scope_node)),
                            val.func.id):
                        out += self._returned_defs(factory)
        return out

    def _returned_defs(self, factory: FuncInfo) -> List[FuncInfo]:
        """Nested defs a factory returns (``return payload`` or a tuple of
        such)."""
        nested = {c.name: self.funcs[id(c)]
                  for c in ast.walk(factory.node)
                  if isinstance(c, (ast.FunctionDef, ast.AsyncFunctionDef))
                  and id(c) in self.funcs}
        out: List[FuncInfo] = []
        for stmt in ast.walk(factory.node):
            if isinstance(stmt, ast.Return) and stmt.value is not None:
                for n in ast.walk(stmt.value):
                    if isinstance(n, ast.Name) and n.id in nested:
                        out.append(nested[n.id])
        return out

    def _resolve_attr_call(self, fi: FuncInfo,
                           call: ast.Call) -> List[FuncInfo]:
        """``module.func(...)`` on an imported scanned module, and
        ``self.method(...)`` inside a class (methods of that name in the
        same module)."""
        f = call.func
        if not (isinstance(f, ast.Attribute) and isinstance(f.value,
                                                            ast.Name)):
            return []
        base = f.value.id
        if base == "self":
            meth = self._enclosing_method(fi)
            if meth is None:
                return []
            return [c for c in self.by_name.get(f.attr, [])
                    if c.module is fi.module and c.cls is not None]
        dotted = self.mod_alias[fi.module.relpath].get(base)
        if dotted is None:
            imp = self.from_imports[fi.module.relpath].get(base)
            if imp is not None:
                dotted = f"{imp[0]}.{imp[1]}"
        src = self.by_dotted.get(dotted) if dotted else None
        if src is not None and f.attr in self.top[src.relpath]:
            return [self.top[src.relpath][f.attr]]
        return []

    @staticmethod
    def _enclosing_method(fi: FuncInfo) -> Optional[FuncInfo]:
        while fi is not None and fi.cls is None:
            fi = fi.parent
        return fi

    # -- captured marking ----------------------------------------------------

    def _contract_traced(self, fi: FuncInfo) -> Optional[str]:
        rel = fi.module.relpath
        for suffix, excl in _CAPTURED_MODULES.items():
            inside = (f"/{suffix}" in f"/{rel}" if suffix.endswith("/")
                      else rel == suffix or rel.endswith("/" + suffix))
            if inside and not (excl and fi.name.endswith(excl)):
                return f"captured module {suffix}"
        if fi.name in _AGG_METHODS and fi.cls is not None \
                and _class_is_aggregator(fi.cls):
            return "Aggregator method contract"
        return None

    def _mark_traced(self) -> None:
        work: List[FuncInfo] = []

        def mark(fi: FuncInfo, why: str, seed: bool = False):
            fi.seed_params |= seed
            if not fi.traced:
                fi.traced, fi.traced_via = True, why
                work.append(fi)

        for fi in self.funcs.values():
            why = self._contract_traced(fi)
            if why:
                mark(fi, why, fi.name in _AGG_SEEDED and fi.cls is not None)
        for mod in self.modules:
            for node in ast.walk(mod.tree):
                if isinstance(node, ast.Call):
                    for kw in node.keywords:
                        if kw.arg == "tick" and isinstance(kw.value,
                                                           ast.Name):
                            encl = self._enclosing_func(mod, node)
                            for cand in self.resolve_name(mod, encl,
                                                          kw.value.id):
                                mark(cand, "a program's tick", True)
                elif isinstance(node, (ast.With, ast.AsyncWith)) and any(
                        self._is_graph_block(mod, it.context_expr)
                        for it in node.items):
                    encl = self._enclosing_func(mod, node)
                    for stmt in node.body:
                        for call in ast.walk(stmt):
                            if not isinstance(call, ast.Call):
                                continue
                            if isinstance(call.func, ast.Name):
                                cands = self.resolve_name(mod, encl,
                                                          call.func.id)
                            elif isinstance(call.func, ast.Attribute) \
                                    and self.module_path(
                                        mod, call.func) is None:
                                cands = [c for c in self.by_name.get(
                                    call.func.attr, []) if c.cls is None]
                            else:
                                cands = []
                            for cand in cands:
                                mark(cand, "called in a torch.cuda.graph "
                                           "block", True)

        # transitive closure over calls from captured functions
        while work:
            fi = work.pop()
            for child in ast.iter_child_nodes(fi.node):
                for sub in ast.walk(child):
                    if isinstance(sub, (ast.FunctionDef,
                                        ast.AsyncFunctionDef)) \
                            and id(sub) in self.funcs:
                        mark(self.funcs[id(sub)],
                             f"nested in captured {fi.qualname}")
            for call in ast.walk(fi.node):
                if not isinstance(call, ast.Call):
                    continue
                if isinstance(call.func, ast.Name):
                    cands = self.resolve_name(fi.module, fi, call.func.id)
                else:
                    cands = self._resolve_attr_call(fi, call)
                for cand in cands:
                    mark(cand, f"called from captured {fi.qualname}")

    def _is_graph_block(self, mod: SourceModule, expr: ast.AST) -> bool:
        """``torch.cuda.graph(...)`` (called, as a context manager)."""
        return isinstance(expr, ast.Call) and self.module_path(
            mod, expr.func) == "torch.cuda.graph"

    def _enclosing_func(self, mod: SourceModule,
                        node: ast.AST) -> Optional[FuncInfo]:
        best = None
        for fi in self.funcs.values():
            if fi.module is mod and _contains(fi.node, node):
                if best is None or _contains(best.node, fi.node):
                    best = fi
        return best

    # -- taint ---------------------------------------------------------------

    def tainted_names(self, fi: FuncInfo) -> Set[str]:
        """Names inside `fi` that (may) hold tensors: the seeded parameters
        (all non-static ones where `seed_params`, else those the body feeds
        to torch) closed over the body's assignments and loops."""
        cached = self._taint_cache.get(id(fi.node))
        if cached is not None:
            return cached
        params = set(fi.tracer_params())
        seed = params if fi.seed_params else self._torch_fed_params(
            fi, params)
        tainted = self._taint_fixpoint(fi, seed)
        self._taint_cache[id(fi.node)] = tainted
        return tainted

    def _taint_fixpoint(self, fi: FuncInfo, seed: Set[str]) -> Set[str]:
        tainted = set(seed)
        for _ in range(20):
            before = len(tainted)
            for stmt in iter_own(fi.node):
                if isinstance(stmt, ast.Assign):
                    for tgt, val in _assign_pairs(stmt):
                        if self.expr_tainted(fi, val, tainted):
                            tainted |= _target_names(tgt)
                elif isinstance(stmt, (ast.AugAssign, ast.AnnAssign)) \
                        and stmt.value is not None \
                        and isinstance(stmt.target, ast.Name) \
                        and self.expr_tainted(fi, stmt.value, tainted):
                    tainted.add(stmt.target.id)
                elif isinstance(stmt, (ast.For, ast.comprehension)):
                    tainted |= self._loop_taint(fi, stmt.target, stmt.iter,
                                                tainted)
                elif isinstance(stmt, ast.withitem) \
                        and stmt.optional_vars is not None \
                        and self.expr_tainted(fi, stmt.context_expr,
                                              tainted):
                    tainted |= _target_names(stmt.optional_vars)
            if len(tainted) == before:
                break
        return tainted

    def _loop_taint(self, fi: FuncInfo, target: ast.AST, it: ast.AST,
                    tainted: Set[str]) -> Set[str]:
        """Names a loop (or comprehension) over `it` binds to tensors:
        ``.keys()`` and ``range`` none, ``.items()`` and ``enumerate`` the
        value only, ``zip`` element by element."""
        if isinstance(it, ast.Call):
            f = it.func
            fname = f.attr if isinstance(f, ast.Attribute) else (
                f.id if isinstance(f, ast.Name) else "")
            pair = isinstance(target, ast.Tuple) and len(target.elts) == 2
            if fname in ("keys", "range"):
                return set()
            if fname == "items" and pair and isinstance(f, ast.Attribute):
                return (_target_names(target.elts[1])
                        if self.expr_tainted(fi, f.value, tainted) else set())
            if fname == "enumerate" and pair and it.args:
                return (_target_names(target.elts[1])
                        if self.expr_tainted(fi, it.args[0], tainted)
                        else set())
            if fname == "zip" and isinstance(target, ast.Tuple) \
                    and len(target.elts) == len(it.args):
                out: Set[str] = set()
                for t, a in zip(target.elts, it.args):
                    if self.expr_tainted(fi, a, tainted):
                        out |= _target_names(t)
                return out
        return (_target_names(target)
                if self.expr_tainted(fi, it, tainted) else set())

    def _torch_fed_params(self, fi: FuncInfo,
                          params: Set[str]) -> Set[str]:
        """Parameters the body passes bare to a ``torch.*`` call, or calls
        a tensor method on — a parameter used only as host configuration
        (a shape, a flag) never seeds."""
        out: Set[str] = set()
        for node in iter_own(fi.node):
            if not isinstance(node, ast.Call):
                continue
            if self.torch_op(fi.module, node) is not None:
                for arg in list(node.args) + [k.value for k in
                                              node.keywords]:
                    if isinstance(arg, ast.Name) and arg.id in params:
                        out.add(arg.id)
            elif isinstance(node.func, ast.Attribute) \
                    and node.func.attr in _TENSOR_METHODS \
                    and isinstance(node.func.value, ast.Name) \
                    and node.func.value.id in params:
                out.add(node.func.value.id)
        return out

    def expr_tainted(self, fi: FuncInfo, expr: ast.AST,
                     tainted: Set[str]) -> bool:
        """Conservative may-be-a-tensor for an expression."""
        if expr is None:
            return False
        if isinstance(expr, ast.Name):
            return expr.id in tainted
        if isinstance(expr, ast.Attribute):
            if expr.attr in _STATIC_ATTRS or expr.attr in self.host_props:
                return False
            return self.expr_tainted(fi, expr.value, tainted)
        if isinstance(expr, ast.Subscript):
            return self.expr_tainted(fi, expr.value, tainted)
        if isinstance(expr, ast.Call):
            return self._call_tainted(fi, expr, tainted)
        if isinstance(expr, ast.BinOp):
            return self.expr_tainted(fi, expr.left, tainted) \
                or self.expr_tainted(fi, expr.right, tainted)
        if isinstance(expr, ast.UnaryOp):
            return self.expr_tainted(fi, expr.operand, tainted)
        if isinstance(expr, ast.BoolOp):
            return any(self.expr_tainted(fi, v, tainted)
                       for v in expr.values)
        if isinstance(expr, ast.Compare):
            return self._compare_tainted(fi, expr, tainted)
        if isinstance(expr, (ast.Tuple, ast.List, ast.Set)):
            return any(self.expr_tainted(fi, e, tainted) for e in expr.elts)
        if isinstance(expr, ast.Dict):
            return any(self.expr_tainted(fi, v, tainted)
                       for v in expr.values if v is not None)
        if isinstance(expr, ast.IfExp):
            return self.expr_tainted(fi, expr.body, tainted) \
                or self.expr_tainted(fi, expr.orelse, tainted)
        if isinstance(expr, ast.Starred):
            return self.expr_tainted(fi, expr.value, tainted)
        if isinstance(expr, (ast.ListComp, ast.SetComp, ast.GeneratorExp)):
            return self.expr_tainted(fi, expr.elt, tainted)
        if isinstance(expr, ast.DictComp):
            return self.expr_tainted(fi, expr.value, tainted)
        return False

    def _call_tainted(self, fi: FuncInfo, expr: ast.Call,
                      tainted: Set[str]) -> bool:
        f = expr.func
        if self.torch_op(fi.module, expr) is not None:
            return self.is_tensor_call(fi.module, expr)
        if isinstance(f, ast.Name) and (f.id in _STATIC_BUILTINS
                                        or f.id in _SYNC_RESULTS):
            return False
        if isinstance(f, ast.Attribute) and (
                f.attr in _STATIC_METHODS or f.attr in _SYNC_RESULT_METHODS
                or f.attr == "keys"):
            return False
        if self._host_call(fi, expr):
            return False
        if isinstance(f, ast.Attribute):
            if self.module_path(fi.module, f) is not None:
                return False        # numpy / random: host values
            if self.expr_tainted(fi, f.value, tainted):
                return True
        return any(self.expr_tainted(fi, a, tainted)
                   for a in list(expr.args)
                   + [k.value for k in expr.keywords])

    def _host_call(self, fi: FuncInfo, call: ast.Call) -> bool:
        """The call resolves to scanned defs, each annotated to return a
        host value."""
        if isinstance(call.func, ast.Name):
            cands = self.resolve_name(fi.module, fi, call.func.id)
        else:
            cands = self._resolve_attr_call(fi, call)
        return bool(cands) and all(_host_annotation(c.node.returns)
                                   for c in cands)

    def _compare_tainted(self, fi: FuncInfo, expr: ast.Compare,
                         tainted: Set[str]) -> bool:
        # `x is None` is a structure check: a tensor is never None
        if all(isinstance(op, (ast.Is, ast.IsNot)) for op in expr.ops):
            return False
        # `"key" in d` asks about a dict's keys, not its tensors
        if all(isinstance(op, (ast.In, ast.NotIn)) for op in expr.ops) \
                and isinstance(expr.left, ast.Constant) \
                and isinstance(expr.left.value, str):
            return False
        return self.expr_tainted(fi, expr.left, tainted) or any(
            self.expr_tainted(fi, c, tainted) for c in expr.comparators)

    def not_tensors(self, fi: FuncInfo) -> Dict[int, Set[str]]:
        """id(node) -> the names known not to be tensors there: inside
        ``if not isinstance(x, torch.Tensor):`` (and the ``else`` of
        ``if isinstance(x, torch.Tensor):``) ``x`` is a host value."""
        out: Dict[int, Set[str]] = {}
        for node in iter_own(fi.node):
            if not isinstance(node, ast.If):
                continue
            test, negated = node.test, False
            if isinstance(test, ast.UnaryOp) and isinstance(test.op,
                                                            ast.Not):
                test, negated = test.operand, True
            if not (isinstance(test, ast.Call)
                    and isinstance(test.func, ast.Name)
                    and test.func.id == "isinstance" and len(test.args) == 2
                    and isinstance(test.args[0], ast.Name)
                    and "Tensor" in ast.unparse(test.args[1])):
                continue
            for stmt in (node.body if negated else node.orelse):
                for sub in ast.walk(stmt):
                    out.setdefault(id(sub), set()).add(test.args[0].id)
        return out

    def traced_functions(self) -> List[FuncInfo]:
        """The captured functions."""
        return [fi for fi in self.funcs.values() if fi.traced]


def _static_annotation(ann: ast.AST) -> bool:
    """True when a parameter annotation marks host configuration."""
    text = ast.unparse(ann)
    if any(tok in text for tok in _ARRAY_ANN):
        return False
    return any(tok in text for tok in _STATIC_ANN)


def _target_names(tgt: ast.AST) -> Set[str]:
    """Names an assignment target binds: ``x[i] = ...`` and ``x.a = ...``
    bind ``x`` (not ``i``)."""
    if isinstance(tgt, ast.Name):
        return {tgt.id}
    if isinstance(tgt, (ast.Tuple, ast.List)):
        return set().union(*(_target_names(e) for e in tgt.elts))
    if isinstance(tgt, (ast.Starred, ast.Subscript, ast.Attribute)):
        return _target_names(tgt.value)
    return set()


def _host_annotation(ann: Optional[ast.AST]) -> bool:
    """A return annotation that names only host types (``bool``, ``int``,
    ``Tuple[int, int]``, ``torch.device``, ...)."""
    if ann is None:
        return False
    text = ast.unparse(ann).replace("torch.", "")
    for tok in _HOST_TYPES:
        text = text.replace(tok, "")
    return text.strip("[], ") == ""


def iter_own(fnode: ast.AST):
    """Walk a function body WITHOUT descending into nested function/class
    defs (those are separate FuncInfos, analysed on their own)."""
    stack = list(ast.iter_child_nodes(fnode))
    while stack:
        node = stack.pop()
        yield node
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef, ast.Lambda)):
            stack.extend(ast.iter_child_nodes(node))


def _assign_pairs(stmt: ast.Assign):
    """(target, value) pairs, parallel tuple assignments ``a, b = x, y``
    element-wise and ``a, b = f()`` as a whole."""
    for tgt in stmt.targets:
        if isinstance(tgt, (ast.Tuple, ast.List)) \
                and isinstance(stmt.value, (ast.Tuple, ast.List)) \
                and len(tgt.elts) == len(stmt.value.elts):
            for t, v in zip(tgt.elts, stmt.value.elts):
                yield t, v
        else:
            yield tgt, stmt.value


def _class_is_aggregator(cls: ast.ClassDef) -> bool:
    for b in cls.bases:
        name = b.id if isinstance(b, ast.Name) else (
            b.attr if isinstance(b, ast.Attribute) else "")
        if "Aggregator" in name or name in ("ACED", "ACEIncremental",
                                            "CA2FL", "FedBuff"):
            return True
    return False


def _contains(outer: ast.AST, inner: ast.AST) -> bool:
    if outer is inner:
        return False
    return any(n is inner for n in ast.walk(outer))


def build_index(modules: List[SourceModule]) -> Index:
    return Index(modules)
