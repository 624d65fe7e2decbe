"""Donation/lease-discipline pass (DN): no write into a leased carry, no
use after hand-off.

Counterpart of ``sitewhere_tpu/analysis/donation.py`` (the rule ids are
kept).  The reference's jitted steps DONATE their carry; PyTorch has no
donation, and the port's form of the same contract is the reverse: a
step never writes into its carry, because ``DeviceStateManager.
lease_packed`` hands a chain the live packed epoch and keeps serving
views of the same buffers to readers ("views of the packed buffers,
which no step writes into").  Three rules:

- ``DN001`` carry-write: inside the step set, an in-place write into a
  step's carry argument or a view of it — a ``*_`` method
  (``add_``, ``copy_``, ``index_put_``, ``scatter_``, ...), an
  ``out=`` argument, a slice assignment or an augmented assignment.
  Carry arguments are the declared :data:`DEFAULT_CARRY_ROOTS`, argument
  1 of every function handed to ``chain_over_slots``, and the parameters
  of step-set callees that such a carry (or a view of it: an attribute,
  a subscript, a view method, ``unpack_state``) is passed to.
- lease/commit: after ``commit_packed(..., lease_token=token)`` closes
  the lease opened by ``ps, token = lease_packed()``, the leased packed
  epoch may have been replaced — ``DN002`` flags any later read of the
  leased variable.
- reservation close: after ``r.commit()`` / ``r.abort()`` on a value
  obtained from ``.reserve(...)`` or ``Reservation(...)``, the buffers
  belong to the batcher (or to nobody) — ``DN003`` flags later reads.
  The defining class's own methods are exempt (the implementation must
  touch its own buffers).

DN002 and DN003 are function-local and source-ordered: a hand-off event
at line N flags loads of the same name at lines > N in the same function
body.  Re-binding the name (a fresh assignment) clears the taint.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Sequence, Set, Tuple

from sitewhere_tpu_torch.analysis.core import (
    Finding,
    FuncInfo,
    Project,
    iter_scope,
)
from sitewhere_tpu_torch.analysis.trace_purity import (
    _CHAIN_DRIVERS,
    TracePurityPass,
)

PASS_ID = "donation"

#: step functions and their carry parameter (qualname suffix -> name):
#: the packed epoch a lease hands out, and its unpacked twin
DEFAULT_CARRY_ROOTS: Dict[str, str] = {
    "pipeline.packed.packed_pipeline_step": "ps",
    "pipeline.packed.chain_over_slots": "ps",
    "pipeline.packed.build_packed_chain.chain": "ps",
    "pipeline.packed.packed_presence_sweep": "ps",
    "pipeline.step.pipeline_step": "state",
    "pipeline.sharded.build_sharded_step.local_step": "state",
    "pipeline.sharded.build_sharded_packed_step.local_step": "ps",
    "pipeline.sharded.build_sharded_packed_chain.local_chain": "ps",
    "state.presence.presence_sweep": "state",
    "state.manager._merge_presence": "cur_si",
}
# argument index of the carry in a function handed to a chain driver
_CHAIN_CARRY_INDEX = 1
# calls whose result shares the argument's buffers
DEFAULT_VIEW_FUNCS = frozenset({"unpack_state", "_rows", "replace"})
# tensor methods that return a view of their receiver
_VIEW_METHODS = frozenset({
    "view", "view_as", "reshape", "narrow", "select", "unsqueeze",
    "squeeze", "t", "transpose", "permute", "expand", "expand_as",
    "flatten", "unflatten", "unbind", "split", "chunk", "as_strided",
    "diagonal", "detach", "contiguous", "movedim", "swapaxes"})
# reservation-producing calls (attribute or name suffixes)
_RESERVE_PRODUCERS = {"reserve", "Reservation"}
_CLOSE_METHODS = {"commit", "abort"}
_LEASE_METHODS = {"lease_packed"}


def _root_name(expr: ast.AST) -> Optional[str]:
    """The variable a view expression reads through: ``ps.si[3]`` ->
    ``ps``, ``state.values.view(-1)`` -> ``state``."""
    while True:
        if isinstance(expr, ast.Name):
            return expr.id
        if isinstance(expr, (ast.Attribute, ast.Subscript, ast.Starred)):
            expr = expr.value
        elif isinstance(expr, ast.Call) and isinstance(
                expr.func, ast.Attribute) \
                and expr.func.attr in _VIEW_METHODS:
            expr = expr.func.value
        else:
            return None


def _params(fi: FuncInfo) -> List[str]:
    a = fi.node.args
    return [p.arg for p in a.posonlyargs + a.args]


class DonationPass:
    pass_id = PASS_ID

    def __init__(self,
                 carry_roots: Optional[Dict[str, str]] = None,
                 view_funcs: Optional[Sequence[str]] = None,
                 reservation_exempt_classes: Sequence[str] = ("Reservation",
                                                             "Batcher")):
        self.carry_roots = dict(DEFAULT_CARRY_ROOTS if carry_roots is None
                                else carry_roots)
        self.view_funcs = frozenset(DEFAULT_VIEW_FUNCS if view_funcs is None
                                    else view_funcs)
        self.exempt_classes = frozenset(reservation_exempt_classes)

    def run(self, project: Project) -> List[Finding]:
        findings: List[Finding] = []
        for qn, (carry, chain) in sorted(self._carry_set(project).items()):
            findings.extend(self._check_carry_writes(
                project, project.functions[qn], carry, chain))
        for qn, fi in sorted(project.functions.items()):
            findings.extend(self._check_function(project, fi))
        return findings

    # -- DN001: the carry set ------------------------------------------------

    def _carry_seeds(self, project: Project
                     ) -> Dict[str, Tuple[Set[str], str]]:
        seeds: Dict[str, Tuple[Set[str], str]] = {}
        for qn, fi in sorted(project.functions.items()):
            for suffix, param in self.carry_roots.items():
                if (qn == suffix or qn.endswith("." + suffix)) \
                        and param in _params(fi):
                    seeds[qn] = ({param}, f"declared carry `{param}` of "
                                          f"{suffix}")
        for mod in project.modules.values():
            for node in ast.walk(mod.tree):
                if not isinstance(node, ast.Call):
                    continue
                canon = project.canonical(mod, node.func)
                index = _CHAIN_DRIVERS.get(canon or "")
                if index is None or index >= len(node.args):
                    continue
                scope = self._scope_of(project, mod, node)
                fi = project.resolve_call(mod, scope, node.args[index])
                if fi is None:
                    continue
                params = _params(fi)
                if _CHAIN_CARRY_INDEX < len(params):
                    names = seeds.get(fi.qualname, (set(), ""))[0]
                    seeds[fi.qualname] = (
                        names | {params[_CHAIN_CARRY_INDEX]},
                        f"argument {_CHAIN_CARRY_INDEX} of a step handed "
                        f"to {canon}() ({mod.rel}:{node.lineno})")
        return seeds

    def _scope_of(self, project: Project, mod, call: ast.Call
                  ) -> Optional[FuncInfo]:
        best = None
        for fi in project.functions.values():
            if fi.module is not mod:
                continue
            n = fi.node
            if n.lineno <= call.lineno <= (n.end_lineno or n.lineno):
                if best is None or n.lineno >= best.node.lineno:
                    best = fi
        return best

    def _carry_set(self, project: Project
                   ) -> Dict[str, Tuple[Set[str], Tuple[str, ...]]]:
        """qualname -> (carry parameter names, evidence chain), closed over
        the calls that pass a carry (or a view of it) on."""
        step_set = TracePurityPass()._step_set(project)
        out: Dict[str, Tuple[Set[str], Tuple[str, ...]]] = {
            qn: (set(names), (why,))
            for qn, (names, why) in self._carry_seeds(project).items()}
        frontier = list(out)
        while frontier:
            qn = frontier.pop()
            fi = project.functions[qn]
            carry, chain = out[qn]
            if len(chain) >= 12:
                continue
            passes, _ = self._carry_flow(project, fi, carry)
            for call, callee, passed in passes:
                if callee.qualname not in step_set \
                        and callee.qualname not in out:
                    continue
                have, had_chain = out.get(callee.qualname, (set(), None))
                if passed <= have:
                    continue
                out[callee.qualname] = (
                    have | passed,
                    had_chain or chain + (
                        f"carry passed by {qn} "
                        f"({fi.module.rel}:{call.lineno})",))
                frontier.append(callee.qualname)
        return out

    def _ordered_nodes(self, fi: FuncInfo):
        nodes = [n for n in iter_scope(fi.node)]
        nodes.sort(key=lambda n: (getattr(n, "lineno", 0),
                                  getattr(n, "col_offset", 0)))
        return nodes

    def _carry_flow(self, project: Project, fi: FuncInfo, carry: Set[str]):
        """Walk ``fi`` in source order tracking the names that hold the
        carry or a view of it (an assignment of anything else rebinds the
        name away).  Returns ``(passes, writes)``: the resolved calls that
        hand a carry view to a callee parameter, with the parameters, and
        the in-place writes into a carry view, with what they are."""
        views = set(carry)
        passes = []
        writes = []
        for node in self._ordered_nodes(fi):
            if isinstance(node, ast.Call):
                func = node.func
                if isinstance(func, ast.Attribute) \
                        and func.attr.endswith("_") \
                        and not func.attr.startswith("_") \
                        and _root_name(func.value) in views:
                    writes.append((node, f"in-place `.{func.attr}()`"))
                elif any(kw.arg == "out" and _root_name(kw.value) in views
                         for kw in node.keywords):
                    writes.append((node, "`out=`"))
                callee = project.resolve_call(fi.module, fi, func)
                if callee is not None and callee.qualname != fi.qualname:
                    params = _params(callee)
                    if callee.cls is not None \
                            and params[:1] in (["self"], ["cls"]):
                        params = params[1:]
                    passed = {params[i] for i, arg in enumerate(node.args)
                              if i < len(params)
                              and _root_name(arg) in views}
                    passed |= {kw.arg for kw in node.keywords
                               if kw.arg in params
                               and _root_name(kw.value) in views}
                    if passed:
                        passes.append((node, callee, passed))
            elif isinstance(node, ast.AugAssign):
                t = node.target
                if _root_name(t) in views:
                    writes.append((node, "slice assignment"
                                   if isinstance(t, ast.Subscript)
                                   else "augmented assignment"))
            elif isinstance(node, ast.Assign):
                for t in node.targets:
                    if isinstance(t, ast.Subscript) \
                            and _root_name(t.value) in views:
                        writes.append((node, "slice assignment"))
                bound = set(self._view_targets(project, fi, node, views))
                for name in self._target_names(node.targets):
                    if name in bound:
                        views.add(name)
                    else:
                        views.discard(name)
        return passes, writes

    def _view_targets(self, project: Project, fi: FuncInfo,
                      node: ast.Assign, views: Set[str]) -> List[str]:
        value = node.value
        if isinstance(value, ast.Call) and not (
                isinstance(value.func, ast.Attribute)
                and value.func.attr in _VIEW_METHODS):
            canon = project.canonical(fi.module, value.func) or ""
            tail = canon.rsplit(".", 1)[-1]
            if tail not in self.view_funcs:
                return []
            roots = [_root_name(a) for a in value.args] + [
                _root_name(kw.value) for kw in value.keywords]
            if tail == "replace" and isinstance(value.func, ast.Attribute):
                roots.append(_root_name(value.func.value))
            if not any(r in views for r in roots):
                return []
            return self._target_names(node.targets)
        if isinstance(value, (ast.Tuple, ast.List)):
            names = []
            for t in node.targets:
                if isinstance(t, (ast.Tuple, ast.List)) \
                        and len(t.elts) == len(value.elts):
                    names += [e.id for e, v in zip(t.elts, value.elts)
                              if isinstance(e, ast.Name)
                              and _root_name(v) in views]
            return names
        if _root_name(value) in views:
            return self._target_names(node.targets)
        return []

    def _check_carry_writes(self, project: Project, fi: FuncInfo,
                            carry: Set[str], chain: Tuple[str, ...]
                            ) -> List[Finding]:
        _, writes = self._carry_flow(project, fi, carry)
        return [project.finding(
            self.pass_id, "DN001", fi, node,
            f"{what} writes into the step's carry (the leased epoch "
            "readers still see)", chain) for node, what in writes]

    # -- DN002 / DN003: per-function flow ------------------------------------

    def _check_function(self, project: Project, fi: FuncInfo
                        ) -> List[Finding]:
        out: List[Finding] = []
        # reservation vars: var -> producing line
        reservations: Dict[str, int] = {}
        # lease pairs: token var -> leased var
        leases: Dict[str, str] = {}
        # taints: var -> (event line, rule, why)
        taints: Dict[str, Tuple[int, str, str]] = {}
        # one finding per tainted name per use-line (`f(ps, ps.si)` is
        # one defect, not two)
        reported: set = set()

        nodes = self._ordered_nodes(fi)
        # calls that ARE an assignment's value are handled inside the
        # Assign branch (taint from the call must land BEFORE the
        # target rebind clears it)
        assign_values = {id(n.value) for n in nodes
                         if isinstance(n, ast.Assign)}
        for node in nodes:
            if isinstance(node, ast.Assign):
                if isinstance(node.value, ast.Call):
                    self._track_call(fi, node.value, reservations, leases,
                                     taints)
                # re-binding clears taint / updates tracking
                names = self._target_names(node.targets)
                for n in names:
                    taints.pop(n, None)
                self._track_assign(project, fi, node, names, reservations,
                                   leases)
            elif isinstance(node, ast.Call) and id(node) not in assign_values:
                self._track_call(fi, node, reservations, leases, taints)
            elif isinstance(node, ast.Name) and isinstance(
                    node.ctx, ast.Load) and node.id in taints:
                line, rule, why = taints[node.id]
                if node.lineno > line \
                        and (node.id, node.lineno) not in reported:
                    reported.add((node.id, node.lineno))
                    out.append(project.finding(
                        self.pass_id, rule, fi, node,
                        f"`{node.id}` used after {why} (line {line}): "
                        "the buffers may already be replaced or owned "
                        "elsewhere"))
        return out

    def _target_names(self, targets) -> List[str]:
        names: List[str] = []
        for t in targets:
            if isinstance(t, ast.Name):
                names.append(t.id)
            elif isinstance(t, (ast.Tuple, ast.List)):
                names.extend(self._target_names(t.elts))
        return names

    def _track_assign(self, project: Project, fi: FuncInfo,
                      node: ast.Assign, names: List[str],
                      reservations, leases) -> None:
        value = node.value
        if not isinstance(value, ast.Call):
            return
        canon = project.canonical(fi.module, value.func) or ""
        tail = canon.rsplit(".", 1)[-1]
        # r = batcher.reserve(...) / Reservation(...)
        if tail in _RESERVE_PRODUCERS and names:
            reservations[names[0]] = node.lineno
        # ps, token = mgr.lease_packed()
        elif tail in _LEASE_METHODS and len(names) == 2:
            leases[names[1]] = names[0]

    def _track_call(self, fi: FuncInfo, call: ast.Call, reservations,
                    leases, taints) -> None:
        func = call.func
        if not isinstance(func, ast.Attribute):
            return
        base = func.value
        base_name = base.id if isinstance(base, ast.Name) else None
        # reservation close: r.commit() / r.abort()
        if func.attr in _CLOSE_METHODS and base_name in reservations:
            if fi.cls in self.exempt_classes:
                return
            taints[base_name] = (
                getattr(call, "end_lineno", call.lineno), "DN003",
                f"`.{func.attr}()` closed the reservation")
        # lease close: mgr.commit_packed(..., lease_token=token)
        elif func.attr == "commit_packed":
            for kw in call.keywords:
                if kw.arg == "lease_token" and isinstance(
                        kw.value, ast.Name) and kw.value.id in leases:
                    leased = leases[kw.value.id]
                    taints[leased] = (
                        getattr(call, "end_lineno", call.lineno), "DN002",
                        "the lease it was obtained under was committed "
                        f"(lease_token=`{kw.value.id}`)")


__all__ = ["DonationPass", "PASS_ID", "DEFAULT_CARRY_ROOTS",
           "DEFAULT_VIEW_FUNCS"]
