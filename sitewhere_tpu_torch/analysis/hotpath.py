"""Hot-path allocation pass (HP): the per-batch allocation worklist.

Counterpart of ``sitewhere_tpu/analysis/hotpath.py``.  Dispatch
bookkeeping (plan assembly, lease hand-off, metrics) is host time spent
on every batch, and the way to shrink it is to strip allocations off
the per-batch path.  This pass turns that into a machine-generated
worklist: functions marked ``@hot_path``
(``sitewhere_tpu_torch/analysis/markers.py``) are the per-batch critical
path, and inside them (plus project-local callees one level down) every
new-object allocation is a finding:

- ``HP001 container-alloc``: list/dict/set displays and
  comprehensions, ``list()``/``dict()``/``set()`` calls.
- ``HP002 ndarray-alloc``: ``numpy.empty/zeros/ones/full/array/
  asarray/arange/stack/concatenate`` and ``torch.empty/zeros/ones/full/
  tensor/as_tensor/arange/cat/stack`` — a fresh array or tensor per
  batch.
- ``HP003 string-build``: f-strings and ``.format()`` — per-batch
  string work is metrics/log material, not dispatch material.
- ``HP004 closure-alloc``: ``lambda`` and nested ``def`` — a fresh
  code-object binding per call.

Findings here are not automatically bugs: the triage contract is that
each is either ELIMINATED (hoisted, pooled, preallocated) or baselined
with a one-line justification, so the baseline file IS the worklist —
burn it down and the dispatch milliseconds follow.
"""

from __future__ import annotations

import ast
from typing import List, Set, Tuple

from sitewhere_tpu_torch.analysis.core import (
    Finding,
    FuncInfo,
    Project,
    iter_scope,
)

PASS_ID = "hot-path-alloc"

_MARKER_NAMES = {"hot_path"}
_CONTAINER_CALLS = {"list", "dict", "set"}
_NDARRAY_CALLS = {
    "numpy.empty", "numpy.zeros", "numpy.ones", "numpy.full",
    "numpy.array", "numpy.asarray", "numpy.arange", "numpy.stack",
    "numpy.concatenate", "numpy.copy",
    "torch.empty", "torch.zeros", "torch.ones", "torch.full",
    "torch.tensor", "torch.as_tensor", "torch.arange", "torch.cat",
    "torch.stack",
}


class HotPathAllocationPass:
    pass_id = PASS_ID

    def __init__(self, propagate_depth: int = 1):
        self.propagate_depth = propagate_depth

    # -- marker discovery ----------------------------------------------------

    def _is_marked(self, project: Project, fi: FuncInfo) -> bool:
        node = fi.node
        for dec in getattr(node, "decorator_list", ()):  # bare or dotted
            target = dec.func if isinstance(dec, ast.Call) else dec
            name = None
            if isinstance(target, ast.Name):
                name = target.id
            elif isinstance(target, ast.Attribute):
                name = target.attr
            if name in _MARKER_NAMES:
                return True
        return False

    def _hot_set(self, project: Project) -> List[Tuple[FuncInfo, Tuple[str, ...]]]:
        marked = [fi for _, fi in sorted(project.functions.items())
                  if self._is_marked(project, fi)]
        out: List[Tuple[FuncInfo, Tuple[str, ...]]] = []
        seen: Set[str] = set()
        frontier: List[Tuple[FuncInfo, Tuple[str, ...], int]] = [
            (fi, (f"marked @hot_path ({fi.module.rel}:{fi.line})",), 0)
            for fi in marked]
        while frontier:
            fi, chain, depth = frontier.pop()
            if fi.qualname in seen:
                continue
            seen.add(fi.qualname)
            out.append((fi, chain))
            if depth >= self.propagate_depth:
                continue
            for call, callee in project.callees(fi):
                if callee.qualname not in seen:
                    frontier.append((
                        callee,
                        chain + (f"called from {fi.qualname} "
                                 f"({fi.module.rel}:{call.lineno})",),
                        depth + 1))
        return out

    # -- the pass ------------------------------------------------------------

    def run(self, project: Project) -> List[Finding]:
        findings: List[Finding] = []
        for fi, chain in self._hot_set(project):
            findings.extend(self._check(project, fi, chain))
        return findings

    def _check(self, project: Project, fi: FuncInfo,
               chain: Tuple[str, ...]) -> List[Finding]:
        out: List[Finding] = []

        def add(rule: str, node: ast.AST, what: str) -> None:
            out.append(project.finding(
                self.pass_id, rule, fi, node,
                f"{what} on the per-batch hot path (allocates every "
                "batch — hoist, pool or preallocate)", chain))

        for node in iter_scope(fi.node):
            if isinstance(node, (ast.List, ast.Dict, ast.Set)) \
                    and not isinstance(getattr(node, "ctx", None),
                                       (ast.Store, ast.Del)):
                kind = type(node).__name__.lower()
                add("HP001", node, f"{kind} display")
            elif isinstance(node, (ast.ListComp, ast.SetComp, ast.DictComp,
                                   ast.GeneratorExp)):
                add("HP001", node, f"{type(node).__name__}")
            elif isinstance(node, ast.JoinedStr):
                add("HP003", node, "f-string construction")
            elif isinstance(node, ast.Call):
                canon = project.canonical(fi.module, node.func)
                if canon in _CONTAINER_CALLS:
                    add("HP001", node, f"`{canon}()` construction")
                elif canon in _NDARRAY_CALLS:
                    add("HP002", node, f"`{canon}` array allocation")
                elif isinstance(node.func, ast.Attribute) \
                        and node.func.attr == "format" \
                        and isinstance(node.func.value, ast.Constant):
                    add("HP003", node, "str.format construction")
        # nested defs / lambdas: closures minted per call
        for child in ast.walk(fi.node):
            if child is fi.node:
                continue
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda)):
                name = getattr(child, "name", "<lambda>")
                out.append(project.finding(
                    self.pass_id, "HP004", fi, child,
                    f"closure `{name}` created per call on the hot path",
                    chain))
        return out


__all__ = ["HotPathAllocationPass", "PASS_ID"]
