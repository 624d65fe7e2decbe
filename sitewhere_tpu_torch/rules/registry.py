"""Per-tenant program store with epoch-published operand tables.

Counterpart of ``sitewhere_tpu/rules/registry.py``: the same catalog, the
same padded numpy tables (``_build_group``), moved to the device once per
publish; the checkpoint payload is byte-compatible with the reference's,
so a snapshot from either package restores in the other.  In the port a
"kernel" below is a group pass of ``rules/compile.py`` and a "compile"
is a new signature.

The ``RegistryMirror`` pattern applied to rule programs: mutations (REST
CRUD, checkpoint restore) edit a host-side program catalog under a lock;
:meth:`ProgramRegistry.publish` rebuilds the operand tables of exactly
the structure groups that changed and swaps in a new immutable
:class:`RulesEpoch`.  The eval thread grabs the current epoch once per
batch and never sees a half-built table; an in-flight batch keeps
evaluating the epoch it started with (epoch isolation — the hot-swap
tests pin this).

The hot-swap contract, concretely: editing a program whose structure key
already exists changes only operand *values* — array shapes are
identical, the structure-keyed kernel cache (``rules/compile.py``) is
untouched, and the swap costs one host build + device put.  Only a
genuinely novel structure (or a power-of-two capacity step: program
rows, tenant map, polygon pool — all on ``pow2_at_least`` ladders, so
growth mints O(log) shapes, not O(n)) can mint a kernel, and the engine
warms it on the MUTATING thread before the epoch becomes current, so
traffic never pays a compile (``engine.RuleEngineRunner.refresh``).
"""

from __future__ import annotations

import json
import threading
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from sitewhere_tpu_torch.device import DeviceLike, resolve_device
from sitewhere_tpu_torch.ids import NULL_ID
from sitewhere_tpu_torch.ops.geo import pad_polygon
from sitewhere_tpu_torch.rules import compile as rcompile
from sitewhere_tpu_torch.rules.dsl import (
    CanonicalProgram,
    MAX_POLY_VERTS,
    PK_GEO,
    RuleProgramError,
    describe_program,
    parse_program,
)
from sitewhere_tpu_torch.schema import pow2_at_least

_CHECKPOINT_VERSION = 1


@dataclass(frozen=True)
class GroupEpoch:
    """One structure group's published, immutable device tables."""

    key: str
    has_geo: bool
    tables: rcompile.GroupTables
    eval_fn: object
    n_programs: int

    def shape_sig(self) -> tuple:
        """The shape identity a compile is keyed on (structure key plus
        the pow2 capacities) — the engine warms one dummy eval per
        unseen signature."""
        return (self.key,) + tuple(
            tuple(a.shape) for a in self.tables)


@dataclass(frozen=True)
class RulesEpoch:
    """The registry's published world: read atomically by the eval
    thread, replaced wholesale by :meth:`ProgramRegistry.publish`."""

    epoch: int
    groups: Tuple[GroupEpoch, ...]


@dataclass
class _Program:
    tenant: int
    canonical: CanonicalProgram
    alert_code: int


class _Group:
    def __init__(self, key: str):
        self.key = key
        self.programs: Dict[Tuple[int, str], _Program] = {}
        self.dirty = True
        self.built: Optional[GroupEpoch] = None

    def tenant_count(self, tenant: int) -> int:
        return sum(1 for (t, _tok) in self.programs if t == tenant)


class ProgramRegistry:
    """Host-side program catalog + operand-table builder."""

    def __init__(self,
                 programs_per_tenant: int = 4,
                 max_programs: int = 262144,
                 tenant_floor: int = 64,
                 resolve_alert: Optional[Callable[[str], int]] = None,
                 resolve_mtype: Optional[Callable[[str], int]] = None,
                 resolve_attr: Optional[Callable[[str, str], int]] = None,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.programs_per_tenant = int(programs_per_tenant)
        self.max_programs = int(max_programs)
        self.tenant_floor = int(tenant_floor)
        self.resolve_alert = resolve_alert or self._default_mint
        self.resolve_mtype = resolve_mtype
        self.resolve_attr = resolve_attr
        self._alert_codes: Dict[str, int] = {}
        self._lock = threading.RLock()
        self._groups: Dict[str, _Group] = {}
        self._by_token: Dict[Tuple[int, str], str] = {}  # -> group key
        self._max_tenant = -1
        self._epoch: Optional[RulesEpoch] = None
        self._epoch_id = 0
        # counters the engine publishes as the rules.* family
        self.swaps = 0          # publishes that rebuilt >= 1 group
        self.builds = 0         # group table rebuilds (host + H2D)

    def _default_mint(self, alert_type: str) -> int:
        code = self._alert_codes.get(alert_type)
        if code is None:
            code = len(self._alert_codes)
            self._alert_codes[alert_type] = code
        return code

    # -- CRUD ----------------------------------------------------------------

    def put_program(self, tenant: int, doc: dict) -> Dict[str, object]:
        """Create or replace one tenant program (validated + canonical
        BEFORE any state changes, so a bad doc can never dirty a group)."""
        prog = parse_program(doc, resolve_mtype=self.resolve_mtype,
                             resolve_attr=self.resolve_attr)
        tenant = int(tenant)
        if tenant < 0:
            raise RuleProgramError(f"bad tenant id {tenant}")
        key = prog.structure_key()
        code = int(self.resolve_alert(prog.alert_type))
        with self._lock:
            handle = (tenant, prog.token)
            old_key = self._by_token.get(handle)
            group = self._groups.get(key)
            if group is None:
                group = _Group(key)
            per_tenant = group.tenant_count(tenant)
            if old_key == key:
                per_tenant -= 1  # replacing in place
            if per_tenant >= self.programs_per_tenant:
                raise RuleProgramError(
                    f"tenant has {self.programs_per_tenant} programs of "
                    f"structure {key!r} already (raise "
                    "rules.programs_per_tenant or vary the structure)")
            if old_key is None \
                    and self.program_count() >= self.max_programs:
                raise RuleProgramError(
                    f"program limit {self.max_programs} reached")
            if old_key is not None and old_key != key:
                old = self._groups[old_key]
                old.programs.pop(handle, None)
                old.dirty = True
                if not old.programs:
                    del self._groups[old_key]
            self._groups.setdefault(key, group)
            group.programs[handle] = _Program(tenant, prog, code)
            group.dirty = True
            self._by_token[handle] = key
            self._max_tenant = max(self._max_tenant, tenant)
        return describe_program(prog)

    def delete_program(self, tenant: int, token: str) -> bool:
        with self._lock:
            handle = (int(tenant), str(token))
            key = self._by_token.pop(handle, None)
            if key is None:
                return False
            group = self._groups[key]
            group.programs.pop(handle, None)
            group.dirty = True
            if not group.programs:
                del self._groups[key]
            return True

    def get_program(self, tenant: int, token: str
                    ) -> Optional[Dict[str, object]]:
        with self._lock:
            key = self._by_token.get((int(tenant), str(token)))
            if key is None:
                return None
            prog = self._groups[key].programs[(int(tenant), str(token))]
        return describe_program(prog.canonical)

    def list_programs(self, tenant: Optional[int] = None
                      ) -> List[Dict[str, object]]:
        with self._lock:
            progs = [p for g in self._groups.values()
                     for (t, _tok), p in sorted(g.programs.items())
                     if tenant is None or t == int(tenant)]
        return [describe_program(p.canonical) for p in progs]

    def program_count(self) -> int:
        with self._lock:
            return sum(len(g.programs) for g in self._groups.values())

    def group_count(self) -> int:
        with self._lock:
            return len(self._groups)

    # -- epoch build ---------------------------------------------------------

    def _build_group(self, group: _Group) -> GroupEpoch:
        from sitewhere_tpu_torch.rules.dsl import CLAUSE_BUCKETS, PRED_BUCKETS

        progs = [group.programs[h] for h in sorted(group.programs)]
        has_geo = group.key.endswith("g")
        # padded shape straight from the structure key — every group
        # with this key builds congruent tables
        c_pad = int(group.key[1:group.key.index("p")])
        p_pad = int(group.key[group.key.index("p") + 1:].rstrip("g"))
        G = pow2_at_least(len(progs), 8)
        T = pow2_at_least(self._max_tenant + 1, self.tenant_floor)
        S = self.programs_per_tenant

        kind = np.zeros((G, c_pad, p_pad), np.int32)
        pint = np.zeros((G, c_pad, p_pad, 4), np.int32)
        pf = np.zeros((G, c_pad, p_pad), np.float32)
        meta = np.full((G, 4), NULL_ID, np.int32)
        meta[:, 3] = 0
        slots = np.full((T, S), NULL_ID, np.int32)
        polys: List[np.ndarray] = []

        for row, p in enumerate(progs):
            meta[row] = (p.tenant, p.alert_code,
                         p.canonical.alert_level, 1)
            free = np.nonzero(slots[p.tenant] == NULL_ID)[0]
            slots[p.tenant, free[0]] = row
            for ci, clause in enumerate(p.canonical.clauses):
                for pi, pred in enumerate(clause):
                    i1 = pred.i1
                    if pred.kind == PK_GEO:
                        i1 = len(polys)
                        polys.append(pad_polygon(pred.polygon,
                                                 MAX_POLY_VERTS))
                    kind[row, ci, pi] = pred.kind
                    pint[row, ci, pi] = (pred.op, pred.i0, i1, pred.i2)
                    pf[row, ci, pi] = np.float32(pred.f0)

        Z = pow2_at_least(len(polys), 8)
        verts = np.zeros((Z if has_geo else 1, MAX_POLY_VERTS, 2),
                         np.float32)
        if polys:
            verts[:len(polys)] = np.stack(polys)

        # the host tables are this build's own: the device copies (on the
        # CPU, views) are never written again
        tables = rcompile.GroupTables(*(
            torch.from_numpy(a).to(self.device)
            for a in (kind, pint, pf, meta, slots, verts)))
        self.builds += 1
        return GroupEpoch(key=group.key, has_geo=has_geo, tables=tables,
                          eval_fn=rcompile.kernel_for(group.key),
                          n_programs=len(progs))

    def publish(self) -> Optional[RulesEpoch]:
        """Rebuild dirty groups and swap in a fresh epoch (double-buffer:
        the outgoing epoch's arrays are never touched).  Returns the
        current epoch, or None when no programs exist."""
        with self._lock:
            if not self._groups:
                self._epoch = None
                return None
            changed = False
            groups: List[GroupEpoch] = []
            for key in sorted(self._groups):
                g = self._groups[key]
                if g.dirty or g.built is None:
                    g.built = self._build_group(g)
                    g.dirty = False
                    changed = True
                groups.append(g.built)
            if changed or self._epoch is None:
                self._epoch_id += 1
                self.swaps += 1
                self._epoch = RulesEpoch(self._epoch_id, tuple(groups))
            return self._epoch

    def current_epoch(self) -> Optional[RulesEpoch]:
        return self._epoch

    def structure_keys(self) -> List[str]:
        with self._lock:
            return sorted(self._groups)

    # -- checkpoint plane ----------------------------------------------------

    def snapshot_payload(self) -> Tuple[bytes, Optional[dict]]:
        """StateProvider body: the program DOCS (the durable identity —
        operand tables and kernels are derived state, rebuilt on the
        first post-restore publish)."""
        with self._lock:
            progs = [{"tenant": t, "doc": json.loads(p.canonical.doc)}
                     for g in self._groups.values()
                     for (t, _tok), p in sorted(g.programs.items())]
            doc = {"version": _CHECKPOINT_VERSION, "programs": progs,
                   "max_tenant": self._max_tenant}
        return (json.dumps(doc).encode(),
                {"programs": len(progs), "epoch": self._epoch_id})

    def restore_payload(self, header: dict, payload: bytes) -> None:
        doc = json.loads(payload.decode())
        with self._lock:
            self._groups.clear()
            self._by_token.clear()
            self._epoch = None
            self._max_tenant = int(doc.get("max_tenant", -1))
        for entry in doc.get("programs", []):
            self.put_program(int(entry["tenant"]), entry["doc"])


__all__ = ["ProgramRegistry", "RulesEpoch", "GroupEpoch"]
