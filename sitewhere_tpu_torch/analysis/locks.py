"""Lock-discipline pass (LK): ordering and blocking-work invariants.

Counterpart of ``sitewhere_tpu/analysis/locks.py``, with the same hot
locks and contracts and the card's transfers recognized in PyTorch.

Catalogs every ``threading.Lock`` / ``RLock`` / ``Condition`` created in
the scanned tree (lock identity = ``module.Class.attr`` or a
module-level name), infers acquisition ORDER from ``with``-statement
nesting propagated through the project call graph, and enforces:

- ``LK001 lock-order-inversion``: the pair (A, B) is acquired in both
  orders somewhere in the project — the classic two-thread deadlock.
  Both edge sites are reported with their full evidence chains.
- ``LK002 self-deadlock``: a plain (non-reentrant) ``Lock`` re-acquired
  while lexically held — directly or through a resolvable call chain.
  ``RLock`` is exempt (re-entrancy is its purpose).
- ``LK003 blocking-under-hot-lock``: a blocking operation — fsync,
  sleep, socket send/recv/accept/connect, subprocess, thread/event
  join/wait, blocking ``queue.put``/``get`` — reached while one of the
  configured HOT locks is held.  The hot set defaults to the three
  locks the per-batch path serializes on: the dispatcher intake lock
  (``PipelineDispatcher._lock``), the step/ring lock
  (``PipelineDispatcher._step_lock``) and the state-manager lease lock
  (``DeviceStateManager._lock``).
- ``LK004 device-sync-under-hot-lock``: card work under a hot lock —
  an H2D transfer (``torch.as_tensor`` / ``torch.tensor`` /
  ``torch.from_numpy`` followed by ``.to(dev)`` or ``.cuda()``, either
  constructor with a non-CPU ``device=``, any ``.cuda()``, a ``.copy_``
  from such a host tensor, any ``non_blocking=True`` copy), a blocking
  D2H (``.item()`` / ``.tolist()`` / ``.cpu()`` / ``.numpy()`` /
  ``.to("cpu")``, ``torch.cuda.synchronize``, an ``Event`` or
  ``Stream`` ``.synchronize()``), or — for classes configured as
  holding device-resident state — ``numpy.asarray`` (which IS the
  blocking D2H when the argument lives on the card).  One slow transfer under the lease lock stalls every
  commit; this is how a REST scan turns into a p99 cliff.
- ``LK005 checkpoint-under-hot-lock``: a call on the configured
  forbidden list — by default ``Checkpointer.save``, which deep-copies
  every store, pickles them, and fsyncs multi-MB snapshot files —
  reached while a hot lock is held (or inside a contracted hot
  region).  The checkpointer owns its own thread and its own save
  lock; the dispatch thread and the three hot-path locks must never
  pay for a snapshot.  Matching is by attribute-path suffix
  (``…checkpointer.save``) AND by resolved callee qualname, so both
  the direct ``self.checkpointer.save()`` and an aliased call are
  caught.

Some functions run under a hot lock held by their CALLER through an
unresolvable indirection (the batcher intake family runs under the
dispatcher's ``_take``, which receives them as closures).  Those are
declared as CONTRACTS — qualname suffixes mapped to the lock they run
under — so the analysis covers the documented "call under the intake
lock" surface the call graph cannot see.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Dict, FrozenSet, List, Optional, Sequence, Set, Tuple

from sitewhere_tpu_torch.analysis.core import (
    Finding,
    FuncInfo,
    Project,
    dotted_name,
    iter_scope,
)
from sitewhere_tpu_torch.analysis.trace_purity import d2h_method, is_cpu_target

PASS_ID = "lock-discipline"

_LOCK_CTORS = {"threading.Lock": "Lock", "threading.RLock": "RLock",
               "threading.Condition": "Condition"}

# canonical call names that block the calling thread
_BLOCKING_CALLS = {
    "os.fsync", "os.fdatasync", "time.sleep", "select.select",
    "subprocess.run", "subprocess.check_output", "subprocess.check_call",
    "subprocess.call", "socket.create_connection",
}
# method names that block regardless of receiver type
_BLOCKING_METHODS = {"fsync", "sendall", "recv", "recv_into", "accept",
                     "connect", "join", "wait", "wait_for", "select"}
# host tensors that a following ``.to(dev)`` / ``.cuda()`` sends to the
# card (LK004)
_HOST_TENSOR_CALLS = {"torch.as_tensor", "torch.tensor", "torch.from_numpy"}
_D2H_CALLS = {"torch.cuda.synchronize"}


@dataclasses.dataclass(frozen=True)
class LockId:
    module: str      # defining module name
    cls: str         # class name or "" for module level
    attr: str        # attribute / variable name
    kind: str        # Lock | RLock | Condition

    @property
    def label(self) -> str:
        owner = f"{self.cls}." if self.cls else ""
        return f"{self.module}:{owner}{self.attr}"

    def matches(self, suffix: str) -> bool:
        """``suffix`` like ``"PipelineDispatcher._step_lock"`` or just
        ``"_lock"`` (class-qualified wins precision)."""
        if "." in suffix:
            cls, attr = suffix.rsplit(".", 1)
            return self.cls == cls and self.attr == attr
        return self.attr == suffix and not self.cls


# The repo's hot-path locks (class-qualified attribute suffixes).
DEFAULT_HOT_LOCKS: FrozenSet[str] = frozenset({
    "PipelineDispatcher._lock",        # batcher intake / commit gate
    "PipelineDispatcher._step_lock",   # step + ring dispatch order
    "DeviceStateManager._lock",        # packed-epoch lease lock
})

# Functions whose docstring contract is "call under <hot lock>" but whose
# call edge is a closure the graph cannot resolve: qualname suffix ->
# human label of the lock they run under.
DEFAULT_LOCK_CONTRACTS: Dict[str, str] = {
    "Batcher._emit": "batcher intake lock (dispatcher._take)",
    "Batcher._emit_adopted": "batcher intake lock (dispatcher._take)",
    "Batcher.add_arrays": "batcher intake lock (dispatcher._take)",
    "Batcher._enqueue_row": "batcher intake lock (dispatcher._take)",
    "Reservation.commit": "batcher intake lock (dispatcher._take)",
}

# Classes whose instance state lives on device: numpy.asarray under their
# locks is a blocking D2H.
DEFAULT_DEVICE_STATE_CLASSES: FrozenSet[str] = frozenset(
    {"DeviceStateManager"})

# Calls that must NEVER execute under a hot-path lock (LK005):
# attribute-path suffix (lowercased) or resolved-callee qualname suffix
# -> why.  Checkpointer.save is the archetype: it deep-copies every
# store under the store locks, pickles the lot, and fsyncs several
# multi-MB files — seconds of work that would wedge dispatch if a hot
# lock were held around it.
DEFAULT_FORBIDDEN_UNDER_HOT: Dict[str, str] = {
    "checkpointer.save": ("Checkpointer.save pickles every store and "
                          "fsyncs multi-MB snapshot files"),
}


def _names_a_device(expr: ast.AST) -> bool:
    """``dev`` / ``device`` / ``x.device`` / ``self._device``: an expression
    that names the card a ``.to()`` moves its receiver to."""
    d = dotted_name(expr)
    if d is None:
        return False
    last = d.rsplit(".", 1)[-1].lstrip("_")
    return last == "dev" or last.endswith("device")


class LockDisciplinePass:
    pass_id = PASS_ID

    def __init__(self,
                 hot_locks: Optional[Sequence[str]] = None,
                 contracts: Optional[Dict[str, str]] = None,
                 device_state_classes: Optional[Sequence[str]] = None,
                 forbidden_under_hot: Optional[Dict[str, str]] = None,
                 max_depth: int = 5):
        self.hot_locks = frozenset(
            DEFAULT_HOT_LOCKS if hot_locks is None else hot_locks)
        self.contracts = dict(
            DEFAULT_LOCK_CONTRACTS if contracts is None else contracts)
        self.device_state_classes = frozenset(
            DEFAULT_DEVICE_STATE_CLASSES if device_state_classes is None
            else device_state_classes)
        self.forbidden_under_hot = dict(
            DEFAULT_FORBIDDEN_UNDER_HOT if forbidden_under_hot is None
            else forbidden_under_hot)
        self.max_depth = max_depth

    # -- inventory -----------------------------------------------------------

    def catalog(self, project: Project) -> Dict[Tuple[str, str, str], LockId]:
        """(module, cls, attr) -> LockId for every lock construction."""
        locks: Dict[Tuple[str, str, str], LockId] = {}
        for mod in project.modules.values():

            def walk(node: ast.AST, cls: str) -> None:
                for child in ast.iter_child_nodes(node):
                    if isinstance(child, ast.ClassDef):
                        walk(child, child.name)
                    else:
                        self._catalog_assign(project, mod, cls, child,
                                             locks)
                        walk(child, cls)

            walk(mod.tree, "")
        return locks

    def _catalog_assign(self, project: Project, mod, cls: str,
                        node: ast.AST, locks) -> None:
        if not isinstance(node, ast.Assign) or not isinstance(
                node.value, ast.Call):
            return
        canon = project.canonical(mod, node.value.func)
        kind = _LOCK_CTORS.get(canon or "")
        if kind is None:
            return
        for tgt in node.targets:
            attr = None
            owner = cls
            if isinstance(tgt, ast.Attribute) and isinstance(
                    tgt.value, ast.Name) and tgt.value.id == "self":
                attr = tgt.attr
            elif isinstance(tgt, ast.Name):
                attr = tgt.id
                if cls:
                    owner = cls   # class-body assignment
                else:
                    owner = ""
            if attr is not None:
                locks[(mod.name, owner, attr)] = LockId(
                    mod.name, owner, attr, kind)

    # -- acquisition analysis ------------------------------------------------

    def _lock_of_with_item(self, project: Project, fi: FuncInfo,
                           item: ast.withitem, locks) -> Optional[LockId]:
        expr = item.context_expr
        d = dotted_name(expr)
        if d is None:
            return None
        parts = d.split(".")
        if parts[0] == "self" and len(parts) == 2 and fi.cls:
            return locks.get((fi.module.name, fi.cls, parts[1]))
        if len(parts) == 1:
            return locks.get((fi.module.name, "", parts[0]))
        return None

    def _with_regions(self, project: Project, fi: FuncInfo, locks
                      ) -> List[Tuple[LockId, ast.With]]:
        out = []
        for node in iter_scope(fi.node):
            if isinstance(node, ast.With):
                for item in node.items:
                    lk = self._lock_of_with_item(project, fi, item, locks)
                    if lk is not None:
                        out.append((lk, node))
        return out

    def _events_under(self, project: Project, fi: FuncInfo, body, locks,
                      depth: int, seen: Set[str]):
        """Yield (kind, node_or_lock, func, chain) events lexically inside
        ``body`` statements, following resolvable calls.  Kinds:
        ``acquire`` (LockId), ``blocking`` / ``h2d`` / ``d2h`` (Call)."""
        if fi.qualname in seen or depth > self.max_depth:
            return
        seen = seen | {fi.qualname}
        stack = list(body)
        while stack:
            node = stack.pop()
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef, ast.Lambda)):
                continue
            if isinstance(node, ast.With):
                for item in node.items:
                    lk = self._lock_of_with_item(project, fi, item, locks)
                    if lk is not None:
                        yield ("acquire", lk, fi, node,
                               (f"{fi.qualname} acquires {lk.label} "
                                f"({fi.module.rel}:{node.lineno})",))
            if isinstance(node, ast.Call):
                kind = self._classify_call(project, fi, node)
                if kind is not None:
                    yield (kind, None, fi, node, ())
                callee = project.resolve_call(fi.module, fi, node.func)
                if callee is not None \
                        and self._forbidden_reason(callee.qualname) \
                        is not None and kind != "forbidden":
                    yield ("forbidden", None, fi, node, ())
                if callee is not None and callee.qualname != fi.qualname:
                    for ev in self._events_under(
                            project, callee, callee.node.body, locks,
                            depth + 1, seen):
                        k, lk, efi, enode, chain = ev
                        yield (k, lk, efi, enode,
                               (f"{fi.qualname} calls {callee.qualname} "
                                f"({fi.module.rel}:{node.lineno})",)
                               + chain)
            stack.extend(ast.iter_child_nodes(node))

    def _forbidden_reason(self, name: Optional[str]) -> Optional[str]:
        if name is None:
            return None
        low = name.lower()
        for suffix, reason in self.forbidden_under_hot.items():
            if low == suffix or low.endswith("." + suffix):
                return reason
        return None

    def _classify_call(self, project: Project, fi: FuncInfo,
                       call: ast.Call) -> Optional[str]:
        if self._forbidden_reason(dotted_name(call.func)) is not None:
            return "forbidden"
        canon = project.canonical(fi.module, call.func)
        if canon in _BLOCKING_CALLS:
            return "blocking"
        transfer = self._transfer(project, fi, call, canon)
        if transfer is not None:
            return transfer
        if canon == "numpy.asarray" \
                and fi.cls in self.device_state_classes:
            return "d2h"
        if isinstance(call.func, ast.Attribute):
            attr = call.func.attr
            if attr in _BLOCKING_METHODS:
                # queue.put()/get() style blocking only when no
                # block=False / timeout present softens it; for
                # event.wait(t) a timeout still blocks — keep it simple
                # and flag, except wait(0)/nowait forms
                if attr in ("put", "get"):
                    return None
                return "blocking"
            if attr in ("put", "get"):
                for kw in call.keywords:
                    if kw.arg == "block" and isinstance(
                            kw.value, ast.Constant) \
                            and kw.value.value is False:
                        return None
                # bare obj.get()/dict.get(...) is unknowable — only flag
                # explicit queue semantics (block=True or timeout kw)
                if any(kw.arg in ("timeout", "block")
                       for kw in call.keywords):
                    return "blocking"
                return None
        return None

    def _transfer(self, project: Project, fi: FuncInfo, call: ast.Call,
                  canon: Optional[str]) -> Optional[str]:
        """``"h2d"`` / ``"d2h"`` for a card transfer, else None."""
        if canon in _D2H_CALLS or d2h_method(call) is not None:
            return "d2h"
        if canon in _HOST_TENSOR_CALLS:
            for kw in call.keywords:
                if kw.arg == "device" and not is_cpu_target(kw.value):
                    return "h2d"
            return None
        if not isinstance(call.func, ast.Attribute):
            return None
        attr = call.func.attr
        if any(kw.arg == "non_blocking" and not (
                isinstance(kw.value, ast.Constant) and not kw.value.value)
               for kw in call.keywords):
            return "h2d"
        if attr == "cuda":
            return "h2d"
        if attr == "to" and (call.args or call.keywords) and (
                self._from_host_tensor(project, fi, call.func.value)
                or any(_names_a_device(t) for t in call.args[:1] + [
                    kw.value for kw in call.keywords
                    if kw.arg == "device"])):
            return "h2d"
        if attr == "copy_" and call.args \
                and self._from_host_tensor(project, fi, call.args[0]):
            return "h2d"
        return None

    def _from_host_tensor(self, project: Project, fi: FuncInfo,
                          expr: ast.AST) -> bool:
        """Is ``expr`` a ``torch.as_tensor/tensor/from_numpy`` call, through
        any chain of method calls on its result (``.pin_memory()``)?"""
        while True:
            if isinstance(expr, ast.Call):
                if project.canonical(fi.module, expr.func) \
                        in _HOST_TENSOR_CALLS:
                    return True
                if isinstance(expr.func, ast.Attribute):
                    expr = expr.func.value
                    continue
            return False

    # -- the pass ------------------------------------------------------------

    def run(self, project: Project) -> List[Finding]:
        locks = self.catalog(project)
        findings: List[Finding] = []
        edges: Dict[Tuple[str, str], Tuple[FuncInfo, ast.AST,
                                           Tuple[str, ...]]] = {}

        for qn, fi in sorted(project.functions.items()):
            if fi.module.name not in project.modules:
                continue
            for lk, wnode in self._with_regions(project, fi, locks):
                held_hot = self._hot_label(lk)
                for ev in self._events_under(project, fi, wnode.body,
                                             locks, 0, set()):
                    kind, inner, efi, enode, chain = ev
                    if kind == "acquire":
                        pair = (lk.label, inner.label)
                        if pair not in edges:
                            edges[pair] = (fi, enode, chain)
                        if inner == lk and lk.kind == "Lock":
                            findings.append(project.finding(
                                self.pass_id, "LK002", efi, enode,
                                f"non-reentrant {lk.label} re-acquired "
                                "while already held (self-deadlock)",
                                (f"outer hold in {fi.qualname} "
                                 f"({fi.module.rel}:{wnode.lineno})",)
                                + chain))
                    elif held_hot is not None:
                        rule = {"blocking": "LK003", "h2d": "LK004",
                                "d2h": "LK004",
                                "forbidden": "LK005"}[kind]
                        what = {"blocking": "blocking call",
                                "h2d": "host→device transfer",
                                "d2h": "blocking device→host sync",
                                "forbidden":
                                    "checkpoint save (forbidden under "
                                    "hot locks)"}[kind]
                        findings.append(project.finding(
                            self.pass_id, rule, efi, enode,
                            f"{what} while holding hot-path lock "
                            f"{lk.label}",
                            (f"lock held by {fi.qualname} "
                             f"({fi.module.rel}:{wnode.lineno})",)
                            + chain))

        findings.extend(self._check_contracts(project, locks))
        findings.extend(self._inversions(project, edges))
        # nested with-regions walk overlapping bodies — dedup by site
        seen: Set[Tuple[str, str, str, int]] = set()
        unique: List[Finding] = []
        for f in findings:
            key = (f.rule, f.path, f.qualname, f.line)
            if key not in seen:
                seen.add(key)
                unique.append(f)
        return unique

    def _hot_label(self, lk: LockId) -> Optional[str]:
        for suffix in self.hot_locks:
            if lk.matches(suffix):
                return suffix
        return None

    def _check_contracts(self, project: Project, locks) -> List[Finding]:
        """Functions documented to run under a hot lock the call graph
        cannot see (closure hand-off): their whole body is a hot
        region."""
        out: List[Finding] = []
        for qn, fi in sorted(project.functions.items()):
            label = None
            for suffix, lock_label in self.contracts.items():
                if qn.endswith(suffix):
                    label = lock_label
                    break
            if label is None:
                continue
            for ev in self._events_under(project, fi, fi.node.body,
                                         locks, 0, set()):
                kind, inner, efi, enode, chain = ev
                if kind in ("blocking", "h2d", "d2h", "forbidden"):
                    rule = {"blocking": "LK003", "h2d": "LK004",
                            "d2h": "LK004", "forbidden": "LK005"}[kind]
                    what = {"blocking": "blocking call",
                            "h2d": "host→device transfer",
                            "d2h": "blocking device→host sync",
                            "forbidden":
                                "checkpoint save (forbidden under hot "
                                "locks)"}[kind]
                    out.append(project.finding(
                        self.pass_id, rule, efi, enode,
                        f"{what} inside a function contracted to run "
                        f"under the {label}",
                        (f"contract: {qn} runs under the {label}",)
                        + chain))
        return out

    def _inversions(self, project: Project, edges) -> List[Finding]:
        out: List[Finding] = []
        reported: Set[Tuple[str, str]] = set()
        for (a, b), (fi, node, chain) in sorted(edges.items()):
            if a == b:
                continue
            rev = edges.get((b, a))
            if rev is None:
                continue
            key = tuple(sorted((a, b)))
            if key in reported:
                continue
            reported.add(key)
            rfi, rnode, rchain = rev
            out.append(project.finding(
                self.pass_id, "LK001", fi, node,
                f"lock-order inversion: {a} → {b} here but {b} → {a} at "
                f"{rfi.module.rel}:{rnode.lineno} ({rfi.qualname})",
                chain + ("reverse order:",) + rchain))
        return out


__all__ = ["LockDisciplinePass", "LockId", "PASS_ID",
           "DEFAULT_HOT_LOCKS", "DEFAULT_LOCK_CONTRACTS",
           "DEFAULT_DEVICE_STATE_CLASSES", "DEFAULT_FORBIDDEN_UNDER_HOT"]
