"""swlint core: the project model every pass shares.

Counterpart of ``sitewhere_tpu/analysis/core.py``; the port keeps its own
copy so that it imports nothing of the reference package.

Parses a Python tree once into a :class:`Project` — modules, a function
index keyed by dotted qualname, an import-alias map per module, and a
conservative package-internal call graph — and defines the structured
:class:`Finding` every pass emits plus the checked-in
:class:`Baseline` that suppresses triaged findings.

Resolution is deliberately conservative (names, ``self.method``, and
imported-module attributes only — no type inference): a pass never
claims an edge it cannot see in the source.  Every finding carries an
evidence chain (the call path from the root that made the code
hot/traced/locked) so a reader can audit the claim without re-running
the analysis.
"""

from __future__ import annotations

import ast
import dataclasses
import hashlib
import json
import os
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

# ---------------------------------------------------------------------------
# findings
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Finding:
    """One structured lint finding (file:line, pass id, evidence chain)."""

    pass_id: str
    rule: str
    path: str        # project-relative
    line: int
    qualname: str
    message: str
    snippet: str = ""
    evidence: Tuple[str, ...] = ()

    @property
    def fingerprint(self) -> str:
        """Stable identity for baselining: pass/rule/file/function plus
        the NORMALIZED source line — line numbers shift on every edit,
        the offending expression does not."""
        key = "|".join((self.pass_id, self.rule, self.path, self.qualname,
                        " ".join(self.snippet.split())))
        return hashlib.sha1(key.encode()).hexdigest()[:16]

    def to_dict(self) -> Dict[str, object]:
        return {
            "pass": self.pass_id, "rule": self.rule, "path": self.path,
            "line": self.line, "qualname": self.qualname,
            "message": self.message, "snippet": self.snippet,
            "evidence": list(self.evidence), "fingerprint": self.fingerprint,
        }

    def format(self) -> str:
        out = (f"{self.path}:{self.line}: [{self.pass_id}/{self.rule}] "
               f"{self.qualname}: {self.message}")
        if self.snippet:
            out += f"\n    > {self.snippet.strip()}"
        for step in self.evidence:
            out += f"\n    via {step}"
        return out


# ---------------------------------------------------------------------------
# project model
# ---------------------------------------------------------------------------


class ModuleInfo:
    def __init__(self, path: str, rel: str, name: str, tree: ast.Module,
                 src: str):
        self.path = path
        self.rel = rel
        self.name = name
        self.tree = tree
        self.lines = src.splitlines()
        # alias -> dotted target, collected from EVERY import statement in
        # the module (function-local imports included — the repo leans on
        # them heavily to break cycles).  ``import numpy as np`` -> np:
        # numpy; ``from jax import lax`` -> lax: jax.lax;
        # ``from pkg.mod import fn`` -> fn: pkg.mod.fn.
        self.imports: Dict[str, str] = {}
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    self.imports[a.asname or a.name.split(".")[0]] = (
                        a.name if a.asname else a.name.split(".")[0])
            elif isinstance(node, ast.ImportFrom) and node.module \
                    and node.level == 0:
                for a in node.names:
                    if a.name == "*":
                        continue
                    self.imports[a.asname or a.name] = \
                        f"{node.module}.{a.name}"

    def line_at(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1]
        return ""


class FuncInfo:
    def __init__(self, qualname: str, node: ast.AST, module: ModuleInfo,
                 cls: Optional[str], parent: Optional[str]):
        self.qualname = qualname
        self.node = node
        self.module = module
        self.cls = cls          # enclosing class name (methods)
        self.parent = parent    # enclosing function qualname (nested defs)
        self.nested: Dict[str, str] = {}   # local def name -> qualname

    @property
    def name(self) -> str:
        return self.node.name

    @property
    def line(self) -> int:
        return self.node.lineno


def iter_scope(node: ast.AST, skip_nested: bool = True) -> Iterator[ast.AST]:
    """Walk a function body without descending into nested function/class
    definitions (their statements belong to their own scope).  Lambda
    bodies are skipped too — they execute when called, not here."""
    stack = list(ast.iter_child_nodes(node))
    while stack:
        child = stack.pop()
        if skip_nested and isinstance(
                child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef,
                        ast.Lambda)):
            continue
        yield child
        stack.extend(ast.iter_child_nodes(child))


def dotted_name(expr: ast.AST) -> Optional[str]:
    """``a.b.c`` attribute chain as a string, or None."""
    parts: List[str] = []
    while isinstance(expr, ast.Attribute):
        parts.append(expr.attr)
        expr = expr.value
    if isinstance(expr, ast.Name):
        parts.append(expr.id)
        return ".".join(reversed(parts))
    return None


class Project:
    """Parsed modules + function index + call resolution."""

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        self.modules: Dict[str, ModuleInfo] = {}
        self.functions: Dict[str, FuncInfo] = {}
        # module name -> {top-level def name -> qualname}
        self._mod_defs: Dict[str, Dict[str, str]] = {}
        # (module, class) -> {method name -> qualname}
        self._methods: Dict[Tuple[str, str], Dict[str, str]] = {}
        self._callee_cache: Dict[str, List] = {}

    # -- construction -------------------------------------------------------

    @classmethod
    def from_paths(cls, paths: Sequence[str],
                   root: Optional[str] = None) -> "Project":
        """Build from a mix of package dirs and single files.  ``root``
        anchors relative paths and dotted module names; defaults to the
        parent of the first path (so scanning ``sitewhere_tpu_torch/``
        yields ``sitewhere_tpu_torch.*`` module names)."""
        paths = [os.path.abspath(p) for p in paths]
        if root is None:
            first = paths[0]
            root = os.path.dirname(first if os.path.isdir(first)
                                   else os.path.dirname(first) or ".")
        proj = cls(root)
        for p in paths:
            if os.path.isdir(p):
                for dirpath, dirnames, filenames in os.walk(p):
                    dirnames[:] = sorted(
                        d for d in dirnames
                        if d != "__pycache__" and not d.startswith("."))
                    for fn in sorted(filenames):
                        if fn.endswith(".py"):
                            proj.add_file(os.path.join(dirpath, fn))
            elif p.endswith(".py"):
                proj.add_file(p)
        return proj

    def add_file(self, path: str) -> Optional[ModuleInfo]:
        rel = os.path.relpath(path, self.root)
        name = rel[:-3].replace(os.sep, ".")
        if name.endswith(".__init__"):
            name = name[:-len(".__init__")]
        with open(path, "r", encoding="utf-8", errors="replace") as f:
            src = f.read()
        try:
            tree = ast.parse(src)
        except SyntaxError:
            return None
        mod = ModuleInfo(path, rel, name, tree, src)
        self.modules[name] = mod
        self._index_module(mod)
        self._callee_cache.clear()
        return mod

    def _index_module(self, mod: ModuleInfo) -> None:
        defs = self._mod_defs.setdefault(mod.name, {})

        def visit(node: ast.AST, prefix: str, cls: Optional[str],
                  parent: Optional[FuncInfo]) -> None:
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef,
                                      ast.AsyncFunctionDef)):
                    qn = f"{prefix}.{child.name}"
                    fi = FuncInfo(qn, child, mod, cls,
                                  parent.qualname if parent else None)
                    self.functions[qn] = fi
                    if parent is not None:
                        parent.nested[child.name] = qn
                    elif cls is not None:
                        self._methods.setdefault(
                            (mod.name, cls), {})[child.name] = qn
                    else:
                        defs[child.name] = qn
                    visit(child, qn, cls, fi)
                elif isinstance(child, ast.ClassDef):
                    visit(child, f"{prefix}.{child.name}", child.name,
                          None)
                else:
                    visit(child, prefix, cls, parent)

        visit(mod.tree, mod.name, None, None)

    # -- resolution ---------------------------------------------------------

    def canonical(self, mod: ModuleInfo, expr: ast.AST) -> Optional[str]:
        """Canonical dotted name of a call target for EXTERNAL matching:
        ``np.asarray`` -> ``numpy.asarray`` (via the module's import
        aliases), bare names pass through, and an attribute on an
        unresolvable base becomes ``*.attr`` (method-call wildcard)."""
        d = dotted_name(expr)
        if d is None:
            if isinstance(expr, ast.Attribute):
                return f"*.{expr.attr}"
            return None
        head, _, rest = d.partition(".")
        target = mod.imports.get(head)
        if target is not None:
            d = f"{target}.{rest}" if rest else target
        return d

    def resolve_call(self, mod: ModuleInfo, scope: Optional[FuncInfo],
                     func_expr: ast.AST) -> Optional[FuncInfo]:
        """Package-internal call resolution (None when unresolvable):
        local nested defs, module-level defs, ``from x import f``
        imports, ``self.method`` within a class, ``alias.func`` on an
        imported project module."""
        if isinstance(func_expr, ast.Name):
            name = func_expr.id
            s = scope
            while s is not None:
                if name in s.nested:
                    return self.functions.get(s.nested[name])
                s = self.functions.get(s.parent) if s.parent else None
            qn = self._mod_defs.get(mod.name, {}).get(name)
            if qn:
                return self.functions.get(qn)
            target = mod.imports.get(name)
            if target and target in self.functions:
                return self.functions[target]
            return None
        if isinstance(func_expr, ast.Attribute):
            base = func_expr.value
            if isinstance(base, ast.Name) and base.id in ("self", "cls") \
                    and scope is not None and scope.cls is not None:
                methods = self._methods.get((mod.name, scope.cls), {})
                qn = methods.get(func_expr.attr)
                return self.functions.get(qn) if qn else None
            d = dotted_name(base)
            if d is not None:
                target = mod.imports.get(d.partition(".")[0])
                if target is not None:
                    modname = d.replace(d.partition(".")[0], target, 1)
                    qn = self._mod_defs.get(modname, {}).get(func_expr.attr)
                    if qn:
                        return self.functions.get(qn)
        return None

    def callees(self, fi: FuncInfo) -> List[Tuple[ast.Call, "FuncInfo"]]:
        """Resolved project-internal calls made directly by ``fi``
        (nested-scope statements excluded), cached."""
        cached = self._callee_cache.get(fi.qualname)
        if cached is not None:
            return cached
        out: List[Tuple[ast.Call, FuncInfo]] = []
        for node in iter_scope(fi.node):
            if isinstance(node, ast.Call):
                target = self.resolve_call(fi.module, fi, node.func)
                if target is not None and target.qualname != fi.qualname:
                    out.append((node, target))
            # bare function REFERENCES passed as callbacks still create
            # reachability (``fori_loop(0, k, body, init)`` passes
            # ``body`` uncalled) — the passes that need those resolve
            # them explicitly; the call graph stays call-sites-only.
        self._callee_cache[fi.qualname] = out
        return out

    def finding(self, pass_id: str, rule: str, fi: FuncInfo,
                node: ast.AST, message: str,
                evidence: Iterable[str] = ()) -> Finding:
        line = getattr(node, "lineno", fi.line)
        return Finding(
            pass_id=pass_id, rule=rule, path=fi.module.rel, line=line,
            qualname=fi.qualname, message=message,
            snippet=fi.module.line_at(line), evidence=tuple(evidence))


# ---------------------------------------------------------------------------
# baseline / suppression file
# ---------------------------------------------------------------------------


class Baseline:
    """Checked-in suppression file: fingerprint -> one-line justification.

    ``apply`` splits findings into (unsuppressed, suppressed) and reports
    stale entries (baselined findings that no longer fire) so the file
    shrinks as the worklist is burned down."""

    VERSION = 1

    def __init__(self, entries: Optional[List[Dict[str, object]]] = None):
        self.entries: List[Dict[str, object]] = entries or []

    @classmethod
    def load(cls, path: str) -> "Baseline":
        if not os.path.exists(path):
            return cls()
        with open(path, "r", encoding="utf-8") as f:
            doc = json.load(f)
        if doc.get("version") != cls.VERSION:
            raise ValueError(f"unsupported baseline version in {path}")
        return cls(doc.get("entries", []))

    def save(self, path: str) -> None:
        doc = {"version": self.VERSION, "entries": self.entries}
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(doc, f, indent=1, sort_keys=False)
            f.write("\n")
        os.replace(tmp, path)

    @property
    def fingerprints(self) -> Dict[str, Dict[str, object]]:
        return {str(e["fp"]): e for e in self.entries}

    def apply(self, findings: Sequence[Finding]):
        known = self.fingerprints
        unsuppressed = [f for f in findings if f.fingerprint not in known]
        suppressed = [f for f in findings if f.fingerprint in known]
        seen = {f.fingerprint for f in findings}
        stale = [e for e in self.entries if str(e["fp"]) not in seen]
        return unsuppressed, suppressed, stale

    @classmethod
    def from_findings(cls, findings: Sequence[Finding],
                      old: Optional["Baseline"] = None,
                      note: str = "TODO: justify") -> "Baseline":
        prior = old.fingerprints if old else {}
        entries = []
        seen = set()
        for f in findings:
            fp = f.fingerprint
            if fp in seen:
                continue
            seen.add(fp)
            entries.append({
                "fp": fp, "pass": f.pass_id, "rule": f.rule,
                "path": f.path, "qualname": f.qualname,
                "snippet": " ".join(f.snippet.split())[:120],
                "note": str(prior.get(fp, {}).get("note", note)),
            })
        return cls(entries)


__all__ = ["Finding", "FuncInfo", "ModuleInfo", "Project", "Baseline",
           "iter_scope", "dotted_name"]
