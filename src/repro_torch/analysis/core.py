"""tracecheck infrastructure: findings, suppressions, baseline, orchestration
(the port's own copy of `repro.analysis.core`, with the port's rule table).

Stdlib-only (``ast``/``json``/``re``): it runs without torch. The rules live
in rules_trace.py / rules_contracts.py; this module owns everything that
does not depend on a rule:

  * `SourceModule` — one parsed file (text, AST, per-line suppressions);
  * `Finding` — a ``file:line RULE message`` report whose *baseline key* is
    ``(rule, path, stripped source line)``, so a grandfathered finding
    survives unrelated line drift;
  * suppression comments ``# tracecheck: ignore[TRC001]`` (comma list or
    ``*``) honoured on the finding's anchor line;
  * the committed baseline file (JSON) of grandfathered findings;
  * `run_tracecheck` — walk the paths, build the capture index, run every
    rule, subtract suppressions and the baseline.
"""
from __future__ import annotations

import ast
import dataclasses
import json
import os
import re
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

_IGNORE_RE = re.compile(r"#\s*tracecheck:\s*ignore\[([A-Za-z0-9_*,\s]+)\]")

#: rule id -> one-line description (the CLI's rule table)
RULES: Dict[str, str] = {
    "TRC001": "host sync in captured code (.item()/.tolist()/.cpu()/"
              ".numpy(), float/int/bool of a tensor, nonzero/masked_select/"
              "unique, Python if/while on a tensor)",
    "TRC002": "RNG off the caller's generator (a torch draw without "
              "generator= in library code; any draw in captured code)",
    "TRC003": "dtype drift (torch.zeros/ones/full/empty/arange/tensor "
              "without dtype= in core/; beyond-f32 float literal in "
              "captured arithmetic)",
    "TRC004": "sharding-contract break (a cache/ring/snapshot buffer "
              "allocated under a mesh whose split comes from neither "
              "guarded_spec nor BlockedFlatCache)",
    "TRC005": "runner-cache key misses a static parameter of the memoised "
              "factory",
}


@dataclasses.dataclass(frozen=True, order=True)
class Finding:
    path: str        # root-relative posix path
    line: int        # 1-indexed anchor line
    rule: str
    message: str
    snippet: str = ""    # stripped anchor source line (baseline key part)

    def key(self) -> Tuple[str, str, str]:
        """Line-number-insensitive identity used for baseline matching."""
        return (self.rule, self.path, self.snippet)

    def format(self) -> str:
        return f"{self.path}:{self.line}: {self.rule} {self.message}"


class SourceModule:
    """One parsed source file plus its per-line suppression sets."""

    syntax_error: Optional[SyntaxError] = None

    def __init__(self, path: str, relpath: str, text: str):
        self.path = path
        self.relpath = relpath.replace(os.sep, "/")
        self.text = text
        self.lines = text.splitlines()
        self.tree = ast.parse(text, filename=path)
        # line -> set of suppressed rule ids ("*" suppresses all)
        self.ignores: Dict[int, set] = {}
        for i, ln in enumerate(self.lines, start=1):
            m = _IGNORE_RE.search(ln)
            if m:
                self.ignores[i] = {tok.strip()
                                   for tok in m.group(1).split(",")
                                   if tok.strip()}

    @classmethod
    def broken(cls, path: str, relpath: str,
               error: SyntaxError) -> "SourceModule":
        """A file that does not parse: an empty module carrying its
        error, reported as a TRC000 finding."""
        m = cls(path, relpath, "")
        m.syntax_error = error
        return m

    def line_text(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1].strip()
        return ""

    def suppressed(self, lineno: int, rule: str) -> bool:
        s = self.ignores.get(lineno)
        return bool(s) and (rule in s or "*" in s)

    def finding(self, node_or_line, rule: str, message: str) -> Finding:
        line = getattr(node_or_line, "lineno", node_or_line)
        return Finding(path=self.relpath, line=line, rule=rule,
                       message=message, snippet=self.line_text(line))


def _iter_py_files(paths: Sequence[str]) -> Iterable[str]:
    for p in paths:
        if os.path.isfile(p) and p.endswith(".py"):
            yield p
        elif os.path.isdir(p):
            for root, dirs, files in os.walk(p):
                dirs[:] = sorted(d for d in dirs
                                 if not d.startswith((".", "__pycache__")))
                for f in sorted(files):
                    if f.endswith(".py"):
                        yield os.path.join(root, f)


def load_modules(paths: Sequence[str],
                 root: Optional[str] = None) -> List[SourceModule]:
    """Parse every ``.py`` under `paths` (files or directories). `root`
    anchors the relative finding paths (default: the working directory)."""
    root = os.path.abspath(root or os.getcwd())
    mods = []
    for f in _iter_py_files(paths):
        absf = os.path.abspath(f)
        rel = os.path.relpath(absf, root)
        with open(absf, "r", encoding="utf-8") as fh:
            text = fh.read()
        try:
            mods.append(SourceModule(absf, rel, text))
        except SyntaxError as e:    # surfaced as a finding, not a crash
            mods.append(SourceModule.broken(absf, rel, e))
    return mods


# --- baseline --------------------------------------------------------------

def load_baseline(path: str) -> List[Tuple[str, str, str]]:
    """Read a baseline: a list of (rule, path, snippet) keys."""
    if not path or not os.path.exists(path):
        return []
    with open(path, "r", encoding="utf-8") as fh:
        data = json.load(fh)
    return [(e["rule"], e["path"], e.get("snippet", ""))
            for e in data.get("findings", [])]


def write_baseline(path: str, findings: Sequence[Finding]) -> None:
    payload = {
        "comment": "tracecheck grandfathered findings of the PyTorch port — "
                   "entries match on (rule, path, source line), so they "
                   "survive line drift; remove entries as the violations "
                   "are fixed",
        "findings": [{"rule": f.rule, "path": f.path, "snippet": f.snippet}
                     for f in sorted(findings)],
    }
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(payload, fh, indent=1, sort_keys=True)
        fh.write("\n")


# --- orchestration ---------------------------------------------------------

def run_tracecheck(paths: Sequence[str], *, root: Optional[str] = None,
                   baseline: Optional[str] = None,
                   rules: Optional[Sequence[str]] = None):
    """Run every rule over `paths`.

    Returns ``(new, baselined, suppressed)`` — three lists of `Finding`:
    findings the baseline does not cover (these fail the check), findings
    matched by a baseline entry, and findings silenced by an inline
    ``# tracecheck: ignore[...]`` comment.
    """
    from repro_torch.analysis import rules_contracts, rules_trace
    from repro_torch.analysis.traceinfo import build_index

    modules = load_modules(paths, root=root)
    index = build_index(modules)
    raw: List[Finding] = []
    for mod in modules:
        err = mod.syntax_error
        if err is not None:
            raw.append(Finding(path=mod.relpath, line=err.lineno or 1,
                               rule="TRC000",
                               message=f"syntax error: {err.msg}"))
    raw += rules_trace.check_host_sync(index)            # TRC001
    raw += rules_trace.check_rng(index)                  # TRC002
    raw += rules_contracts.check_dtype_drift(index)      # TRC003
    raw += rules_contracts.check_sharding_contract(index)    # TRC004
    raw += rules_contracts.check_cache_keys(index)           # TRC005
    if rules:
        keep = set(rules)
        raw = [f for f in raw if f.rule in keep]
    raw = sorted(set(raw))

    by_path = {m.relpath: m for m in modules}
    suppressed, visible = [], []
    for f in raw:
        mod = by_path.get(f.path)
        if mod is not None and mod.suppressed(f.line, f.rule):
            suppressed.append(f)
        else:
            visible.append(f)

    base_keys = set(load_baseline(baseline) if baseline else [])
    new = [f for f in visible if f.key() not in base_keys]
    baselined = [f for f in visible if f.key() in base_keys]
    return new, baselined, suppressed
