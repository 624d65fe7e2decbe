"""Trace-purity pass (TP): no host syncs inside the step set.

Counterpart of ``sitewhere_tpu/analysis/trace_purity.py`` (the name is
kept so a reader finds it).  The port has no ``jit``: its steps are
eager PyTorch launched back to back on the card, and the flagship number
``host_syncs == steps / K`` holds only if nothing the chain runs blocks
the host on the card.  One stray ``.item()`` in the packed chain turns
every ring dispatch into a blocking round-trip, and a data-dependent
shape (``nonzero``, a boolean-mask index) is a hidden one: the host must
read the count before it can size the result.  The same set is the
worklist of CUDA-graph capture of the step, which cannot hold a sync.

The STEP SET is built from three kinds of root:

- the functions handed to ``pipeline.packed.build_packed_chain``'s
  ``chain_over_slots`` (its ``step`` argument);
- the functions handed to ``sitewhere_tpu_torch.parallel.shmap.shard_map``;
- :data:`DEFAULT_STEP_ROOTS`, a declared table that maps each function of
  the reference's traced set (what ``jax.jit``, ``shard_map`` and the
  ``lax`` control-flow bodies trace there) to its counterpart here,

then propagated through the project call graph.  Rules:

- ``TP001 host-sync-in-step``: ``.item()`` / ``.tolist()`` / ``.cpu()`` /
  ``.numpy()`` / ``.synchronize()`` / ``.to("cpu")``,
  ``torch.cuda.synchronize``, ``numpy.asarray`` / ``numpy.array`` /
  ``numpy.frombuffer``, ``print``; and the implicit syncs of a
  data-dependent shape: ``nonzero`` / ``argwhere`` / ``unique`` /
  ``unique_consecutive`` / ``masked_select``, one-argument
  ``torch.where``, ``repeat_interleave`` without ``output_size``, and a
  boolean-mask index where the mask is visibly a comparison.
- ``TP002 host-scalar-coercion``: ``int()/float()/bool()`` of an
  expression that subscripts a step parameter, calls a ``torch``
  function or a tensor reduction — coercions of BARE names are not
  flagged (static arguments are routinely normalized with ``int(k)``).
- ``TP003 uncounted-d2h``: on the host DISPATCH-PATH modules (the
  dispatcher and the packed host side), a blocking device-to-host sync
  in a function that does not reference the counted
  ``pipeline.host_syncs`` surface (``host_syncs`` or a ``_fetch()``
  call).  An optional ``on_fetch`` hook does not count: it may be None.

Every finding carries the evidence chain from the root that put the
function in the step set.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from sitewhere_tpu_torch.analysis.core import (
    Finding,
    FuncInfo,
    Project,
    iter_scope,
)

PASS_ID = "trace-purity"

# canonical names of the wrappers whose argument 0 runs per shard on the
# card: the port's shard_map (and its bare import)
_MAP_WRAPPERS = {"sitewhere_tpu_torch.parallel.shmap.shard_map", "shard_map"}
# canonical names of the chain drivers: {name: index of the step argument}
_CHAIN_DRIVERS = {
    "sitewhere_tpu_torch.pipeline.packed.chain_over_slots": 0,
    "chain_over_slots": 0,
}

#: port qualname (relative to the package) -> the reference function of
#: the traced set it stands for.  Functions of the reference's traced set
#: that have no counterpart of their own are folded into the one that
#: holds their body (see ``REFERENCE_FOLDED``).
DEFAULT_STEP_ROOTS: Dict[str, str] = {
    "analytics.cep.cep_features": "analytics.cep.cep_features",
    "analytics.cep.cep_pass": "analytics.cep.cep_pass",
    "analytics.query.session_eval": "analytics.query.session_eval",
    "analytics.query.session_flush": "analytics.query.session_flush",
    "analytics.query.window_eval": "analytics.query.window_eval",
    "analytics.query.window_flush": "analytics.query.window_flush",
    "analytics.runner._sharded_grid_builder.local":
        "analytics.runner._sharded_grid_builder.local",
    "analytics.runner._window_sharded_flagger.local":
        "analytics.runner._window_sharded_flagger.local",
    "analytics.runner.build_window_grid":
        "analytics.runner.build_window_grid",
    "analytics.runner.detect_anomalies": "analytics.runner.detect_anomalies",
    "analytics.windows.aggregate_windows":
        "analytics.windows.aggregate_windows",
    "analytics.windows.sessionize": "analytics.windows.sessionize",
    "analytics.windows.sliding_aggregates":
        "analytics.windows.sliding_aggregates",
    "analytics.windows.sort_by_device_time":
        "analytics.windows.sort_by_device_time",
    "ops.geo_cuda.points_in_polygons_auto":
        "ops.geo_pallas.points_in_polygons_auto",
    "ops.geo_cuda.points_in_polygons_cuda":
        "ops.geo_pallas.points_in_polygons_pallas",
    "pipeline.packed.build_packed_chain.chain":
        "pipeline.packed.build_packed_chain.chain",
    "ops.scatter.scatter_last_by_time": "ops.scatter.scatter_last_by_time",
    "pipeline.packed.pack_state": "pipeline.packed.pack_state",
    "pipeline.packed.packed_metric_entries":
        "pipeline.packed.packed_metric_entries",
    "pipeline.packed.pack_tables": "pipeline.packed.pack_tables",
    "pipeline.packed.packed_pipeline_step":
        "pipeline.packed.packed_pipeline_step",
    "pipeline.packed.unpack_state": "pipeline.packed.unpack_state",
    "pipeline.sharded.build_sharded_packed_chain.local_chain":
        "pipeline.sharded.build_sharded_packed_chain.local_chain",
    "pipeline.sharded.build_sharded_packed_step.local_step":
        "pipeline.sharded.build_sharded_packed_step.local_step",
    "pipeline.sharded.build_sharded_step.local_step":
        "pipeline.sharded.build_sharded_step.local_step",
    "pipeline.step.pipeline_step": "pipeline.step.pipeline_step",
    "rules.compile.rules_group_eval": "rules.compile.rules_group_eval",
    "rules.compile.rules_prepare_batch": "rules.compile.rules_prepare_batch",
    "rules.compile.sharded_prepare.local_prepare":
        "rules.compile.sharded_prepare.local_prepare",
    "state.manager._merge_presence": "state.manager._merge_presence",
    "state.manager._partition_gather.gather":
        "state.manager._partition_gather.gather",
    "state.presence.presence_sweep": "state.presence.presence_sweep",
}
#: reference functions of the traced set with no function of their own
#: here -> the port function that holds their body, and why
REFERENCE_FOLDED: Dict[str, Tuple[str, str]] = {
    "analytics.query.session_eval._value": (
        "analytics.query.session_eval",
        "the value pick is inline in session_eval"),
    "ops.scatter._winner_rows_scatter": (
        "ops.scatter.winner_rows_by_keys",
        "one winner-row formulation; the reference chose between a "
        "scatter and a sort lowering per backend"),
    "ops.scatter._winner_rows_sort": (
        "ops.scatter.winner_rows_by_keys",
        "one winner-row formulation; the reference chose between a "
        "scatter and a sort lowering per backend"),
    "pipeline.packed.chain_over_slots.body": (
        "pipeline.packed.chain_over_slots",
        "the fori_loop body is the Python loop of chain_over_slots"),
    "pipeline.step._fold_ewma_from": (
        "pipeline.step.fold_ewma_arrays",
        "the EWMA fold is inline in fold_ewma_arrays"),
    "pipeline.telemetry.profile_device_stages.chain_ms.chain": (
        "pipeline.packed.build_packed_chain.chain",
        "the stage profiler times the port's packed chain itself"),
    "rules.compile._attr_col": (
        "rules.compile.rules_prepare_batch",
        "the attribute column gather is inline in rules_prepare_batch"),
}

_SYNC_CALLS = {"numpy.asarray", "numpy.array", "numpy.frombuffer",
               "numpy.copyto", "torch.cuda.synchronize", "print",
               "breakpoint"}
# methods whose call blocks the host on the card (no arguments)
_SYNC_METHODS = {"item", "tolist", "cpu", "numpy", "synchronize"}
# data-dependent output shapes: the host reads a count off the card
_SHAPE_SYNC_CALLS = {"torch.nonzero", "torch.argwhere", "torch.unique",
                     "torch.unique_consecutive", "torch.masked_select"}
_SHAPE_SYNC_METHODS = {"nonzero", "argwhere", "unique",
                       "unique_consecutive", "masked_select"}
# tensor reductions whose result coerced to a Python scalar is a sync
_REDUCTIONS = {"sum", "max", "min", "amax", "amin", "any", "all", "mean",
               "argmax", "argmin", "count_nonzero", "prod"}


def is_cpu_target(node: ast.AST) -> bool:
    """``"cpu"`` / ``torch.device("cpu")`` literal device expressions."""
    if isinstance(node, ast.Constant):
        return node.value == "cpu"
    if isinstance(node, ast.Call) and node.args and isinstance(
            node.func, ast.Attribute) and node.func.attr == "device":
        return is_cpu_target(node.args[0])
    return False


def d2h_method(call: ast.Call) -> Optional[str]:
    """The name of the blocking device-to-host method ``call`` makes, or
    None: a no-argument ``.item/.tolist/.cpu/.numpy/.synchronize`` or a
    ``.to("cpu")``."""
    func = call.func
    if not isinstance(func, ast.Attribute):
        return None
    if func.attr in _SYNC_METHODS and not call.args and not any(
            kw.arg not in ("non_blocking", "memory_format")
            for kw in call.keywords):
        return func.attr
    if func.attr == "to":
        targets = list(call.args[:1]) + [kw.value for kw in call.keywords
                                         if kw.arg == "device"]
        if any(is_cpu_target(t) for t in targets):
            return "to"
    return None


class TracePurityPass:
    pass_id = PASS_ID

    def __init__(self, dispatch_modules: Optional[Set[str]] = None,
                 step_roots: Optional[Dict[str, str]] = None):
        # module-name suffixes whose HOST code is the counted dispatch
        # path (TP003); default = the production dispatch surface
        self.dispatch_modules = dispatch_modules if dispatch_modules \
            is not None else {"runtime.dispatcher", "pipeline.packed"}
        self.step_roots = dict(DEFAULT_STEP_ROOTS if step_roots is None
                               else step_roots)

    # -- root discovery ------------------------------------------------------

    def _step_roots(self, project: Project) -> Dict[str, str]:
        """qualname -> root description for every function the step set
        starts from."""
        roots: Dict[str, str] = {}

        def note(fi: Optional[FuncInfo], why: str) -> None:
            if fi is not None:
                roots.setdefault(fi.qualname, why)

        for qn in sorted(project.functions):
            for suffix, ref in self.step_roots.items():
                if qn == suffix or qn.endswith("." + suffix):
                    note(project.functions[qn],
                         f"declared step root (reference {ref})")
        by_node = {id(fi.node): fi for fi in project.functions.values()}
        for mod in project.modules.values():

            def walk(node: ast.AST, scope: Optional[FuncInfo]) -> None:
                for child in ast.iter_child_nodes(node):
                    inner = scope
                    if isinstance(child, (ast.FunctionDef,
                                          ast.AsyncFunctionDef)):
                        inner = by_node.get(id(child))
                    elif isinstance(child, ast.Call):
                        self._roots_in_call(project, mod, scope, child,
                                            note)
                    walk(child, inner)

            walk(mod.tree, None)
        return roots

    def _roots_in_call(self, project: Project, mod, scope, call: ast.Call,
                       note) -> None:
        canon = project.canonical(mod, call.func)
        index = None
        if canon in _MAP_WRAPPERS:
            index = 0
        elif canon in _CHAIN_DRIVERS:
            index = _CHAIN_DRIVERS[canon]
        if index is not None and index < len(call.args):
            arg = call.args[index]
            if isinstance(arg, (ast.Name, ast.Attribute)):
                note(project.resolve_call(mod, scope, arg),
                     f"{canon}() at {mod.rel}:{call.lineno}")

    # -- propagation ---------------------------------------------------------

    def _step_set(self, project: Project) -> Dict[str, Tuple[str, ...]]:
        roots = self._step_roots(project)
        traced: Dict[str, Tuple[str, ...]] = {
            qn: (why,) for qn, why in roots.items()}
        frontier = list(traced)
        while frontier:
            qn = frontier.pop()
            fi = project.functions.get(qn)
            if fi is None:
                continue
            chain = traced[qn]
            if len(chain) >= 12:
                continue
            for call, callee in project.callees(fi):
                if callee.qualname not in traced:
                    traced[callee.qualname] = chain + (
                        f"called from {qn} ({fi.module.rel}:"
                        f"{call.lineno})",)
                    frontier.append(callee.qualname)
        return traced

    # -- the pass ------------------------------------------------------------

    def run(self, project: Project) -> List[Finding]:
        findings: List[Finding] = []
        traced = self._step_set(project)
        for qn, chain in sorted(traced.items()):
            fi = project.functions.get(qn)
            if fi is None:
                continue
            findings.extend(self._check_step(project, fi, chain))
        findings.extend(self._check_dispatch_path(project, traced))
        return findings

    def _check_step(self, project: Project, fi: FuncInfo,
                    chain: Tuple[str, ...]) -> List[Finding]:
        out: List[Finding] = []
        params = {a.arg for a in fi.node.args.args
                  + fi.node.args.posonlyargs + fi.node.args.kwonlyargs}
        masks = self._mask_names(fi)

        def add(rule: str, node: ast.AST, message: str) -> None:
            out.append(project.finding(self.pass_id, rule, fi, node,
                                       message, chain))

        for node in iter_scope(fi.node):
            if isinstance(node, ast.Subscript) and isinstance(
                    node.ctx, ast.Load) and self._is_mask(node.slice,
                                                          masks):
                add("TP001", node,
                    "boolean-mask index inside the step set: the result's "
                    "length is read off the card (implicit host sync)")
                continue
            if not isinstance(node, ast.Call):
                continue
            canon = project.canonical(fi.module, node.func)
            method = d2h_method(node)
            attr = node.func.attr if isinstance(node.func,
                                                ast.Attribute) else None
            if canon in _SYNC_CALLS:
                add("TP001", node,
                    f"host-sync operation `{canon}` inside the step set "
                    "(blocks the host on the card)")
            elif method is not None:
                add("TP001", node,
                    f"`.{method}()` inside the step set is a blocking "
                    "device-to-host sync")
            elif canon in _SHAPE_SYNC_CALLS or attr in _SHAPE_SYNC_METHODS:
                add("TP001", node,
                    f"`{canon or attr}` inside the step set has a "
                    "data-dependent shape (implicit host sync)")
            elif canon == "torch.where" and len(node.args) == 1:
                add("TP001", node,
                    "one-argument `torch.where` inside the step set is "
                    "`nonzero` (implicit host sync)")
            elif (canon == "torch.repeat_interleave"
                  or attr == "repeat_interleave") and not any(
                      kw.arg == "output_size" for kw in node.keywords):
                add("TP001", node,
                    "`repeat_interleave` without `output_size` inside the "
                    "step set reads its length off the card")
            elif canon in ("int", "float", "bool") and len(node.args) == 1 \
                    and self._coerces_tensor(project, fi, node.args[0],
                                             params):
                add("TP002", node,
                    f"`{canon}()` of a tensor inside the step set copies "
                    "it to the host (blocking sync)")
        return out

    def _mask_names(self, fi: FuncInfo) -> Set[str]:
        """Names bound in ``fi`` to a visibly boolean expression."""
        names: Set[str] = set()
        for node in iter_scope(fi.node):
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name) \
                    and self._is_mask(node.value, names):
                names.add(node.targets[0].id)
        return names

    def _is_mask(self, node: ast.AST, masks: Set[str]) -> bool:
        if isinstance(node, ast.Compare):
            return True
        if isinstance(node, ast.Name):
            return node.id in masks
        if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.Invert):
            return self._is_mask(node.operand, masks)
        if isinstance(node, ast.BinOp) and isinstance(
                node.op, (ast.BitAnd, ast.BitOr, ast.BitXor)):
            return self._is_mask(node.left, masks) \
                or self._is_mask(node.right, masks)
        return False

    def _coerces_tensor(self, project: Project, fi: FuncInfo,
                        arg: ast.AST, params: Set[str]) -> bool:
        for node in ast.walk(arg):
            if isinstance(node, ast.Subscript):
                base = node.value
                if isinstance(base, ast.Name) and base.id in params:
                    return True
            elif isinstance(node, ast.Call):
                canon = project.canonical(fi.module, node.func) or ""
                if canon.startswith("torch.") and not canon.startswith(
                        ("torch.device", "torch.Size", "torch.iinfo",
                         "torch.finfo")):
                    return True
                if isinstance(node.func, ast.Attribute) \
                        and node.func.attr in _REDUCTIONS:
                    return True
        return False

    def _check_dispatch_path(self, project: Project,
                             traced: Dict[str, Tuple[str, ...]]
                             ) -> List[Finding]:
        """TP003: blocking D2H on the host dispatch path that bypasses
        the counted ``pipeline.host_syncs`` surface."""
        out: List[Finding] = []
        for qn, fi in sorted(project.functions.items()):
            if qn in traced:
                continue
            if not any(fi.module.name == m or fi.module.name.endswith(
                    "." + m) for m in self.dispatch_modules):
                continue
            if self._counted(fi):
                continue
            for node in iter_scope(fi.node):
                if not isinstance(node, ast.Call):
                    continue
                canon = project.canonical(fi.module, node.func)
                method = d2h_method(node)
                if canon == "torch.cuda.synchronize" or method is not None:
                    out.append(project.finding(
                        self.pass_id, "TP003", fi, node,
                        "blocking device-to-host sync on the dispatch path "
                        "bypasses the counted pipeline.host_syncs "
                        "surface"))
        return out

    def _counted(self, fi: FuncInfo) -> bool:
        """Does ``fi`` reference the counted surface: ``host_syncs``, or a
        ``_fetch()`` call (the views' counted fetch)?"""
        for node in iter_scope(fi.node):
            if isinstance(node, ast.Attribute) and node.attr == "host_syncs":
                return True
            if isinstance(node, ast.Name) and node.id == "host_syncs":
                return True
            if isinstance(node, ast.Call) and isinstance(
                    node.func, ast.Attribute) and node.func.attr == "_fetch":
                return True
        return False


__all__ = ["TracePurityPass", "PASS_ID", "DEFAULT_STEP_ROOTS",
           "REFERENCE_FOLDED", "d2h_method", "is_cpu_target"]
