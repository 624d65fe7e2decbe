"""Bring-your-own-rules DSL: declarative per-tenant rule programs.

The port's own copy of ``sitewhere_tpu/rules/dsl.py`` (a module with no
JAX in it), on the port's ``ids`` and ``schema``: the same doc gives the
same canonical form and the same structure key in both packages.  In the
port a "jitted kernel" below is one group-eval signature
(``rules/compile.py``).

The reference platform's scenario diversity came from user-supplied
Groovy scripts hot-loaded into every microservice — arbitrary host code,
one interpreter activation per event.  Here the same surface is a small
declarative language whose programs COMPILE: a program is a disjunction
of conjunctive clauses over typed predicates (threshold / EWMA-window /
rate, geofence containment, metadata-join attribute compares, event-type
gates), and every constant in it — thresholds, polygon vertices, window
choices, attribute ids — is lifted out of the program body into operand
tables.  What remains is the *structure*: padded clause/predicate counts
plus whether the geofence lane is live.  Programs sharing a structure
share one jitted kernel (see ``rules/compile.py``), which is how 100k
tenant programs collapse into single-digit compiled shapes.

Structure-key contract
----------------------
``structure_key()`` maps a canonical program to one of at most
``len(CLAUSE_BUCKETS) * len(PRED_BUCKETS) * 2`` strings (8 with the
default buckets).  The key depends ONLY on padded shape + geo-lane
presence — never on constants — so swapping a tenant's thresholds,
polygons or alert levels can never mint a new kernel.  The bound is a
*guarantee by construction*, not a property of any particular workload:
``tools/rulebench.py`` loads 100k skewed synthetic programs and measures
exactly this.

Normal form: ``when`` is normalized to DNF — ``{"any": [{"all": [...]},
...]}`` — with clause/predicate lists canonically sorted (AND/OR are
commutative), so programs that differ only in spelling order share
structure AND operand layout.  Nested ``any`` inside ``all`` is rejected
(v1 keeps the kernel a fixed two-level reduction; de Morgan rewrites are
the caller's job).
"""

from __future__ import annotations

import json
import math
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from sitewhere_tpu_torch.ids import NULL_ID
from sitewhere_tpu_torch.schema import (
    AlertLevel,
    ComparisonOp,
    DEFAULT_EWMA_HALFLIVES_S,
    EventType,
)

# -- limits (the structure-bucket ladder) -----------------------------------

MAX_CLAUSES = 4
MAX_PREDS = 8
# padded sizes snap UP onto these rungs; the coarse floors are what caps
# the distinct-shape count at 2 * 2 * 2 = 8 regardless of program mix
CLAUSE_BUCKETS = (2, 4)
PRED_BUCKETS = (4, 8)
MAX_POLY_VERTS = 8
MAX_STRUCTURE_KEYS = len(CLAUSE_BUCKETS) * len(PRED_BUCKETS) * 2

# -- predicate kinds (operand-table codes) ----------------------------------

PK_PAD = 0          # padding slot: identity under AND
PK_VALUE = 1        # instantaneous measurement value vs threshold
PK_EWMA = 2         # trailing EWMA (window_s snaps to a shared timescale)
PK_RATE = 3         # rate of change since the device's previous sample
PK_GEO = 4          # geofence containment (polygon in the group's pool)
PK_ATTR = 5         # device/asset attribute compare (metadata join)
PK_EVENT_TYPE = 6   # event-type gate

_PRED_NAMES = {
    "value": PK_VALUE, "ewma": PK_EWMA, "rate": PK_RATE,
    "geo": PK_GEO, "attr": PK_ATTR, "event_type": PK_EVENT_TYPE,
}

_OP_NAMES = {
    "gt": ComparisonOp.GT, "lt": ComparisonOp.LT,
    "gte": ComparisonOp.GTE, "lte": ComparisonOp.LTE,
    "eq": ComparisonOp.EQ, "neq": ComparisonOp.NEQ,
}

_LEVEL_NAMES = {
    "info": AlertLevel.INFO, "warning": AlertLevel.WARNING,
    "error": AlertLevel.ERROR, "critical": AlertLevel.CRITICAL,
}

# Alert events are the one type a program may NOT gate on: BYO programs
# evaluate device telemetry; matching the engine's own (or the built-in
# path's) derived alerts would self-amplify through the re-injection
# loop.  The engine additionally masks ALERT rows at eval time.
_EVENT_TYPE_NAMES = {
    t.name.lower(): int(t) for t in EventType if t != EventType.ALERT
}

ATTR_TABLE_DEVICE = 0
ATTR_TABLE_ASSET = 1
_ATTR_TABLES = {"device": ATTR_TABLE_DEVICE, "asset": ATTR_TABLE_ASSET}


class RuleProgramError(ValueError):
    """Validation failure for a rule-program doc (maps to HTTP 400)."""


@dataclass(frozen=True)
class CanonicalPred:
    """One predicate slot in canonical operand form.

    Every constant lives in the operand fields — ``f0`` (float compare
    value), ``i0``/``i1``/``i2`` (int operands, meaning per ``kind``;
    see ``rules/compile.py`` for the kernel-side decode) — plus the
    polygon ring for geo predicates (pooled per group at build time).
    """

    kind: int
    op: int = 0
    f0: float = 0.0
    i0: int = NULL_ID
    i1: int = 0
    i2: int = 0
    polygon: Optional[Tuple[Tuple[float, float], ...]] = None

    def sort_key(self) -> tuple:
        return (self.kind, self.op, self.i0, self.i1, self.i2, self.f0,
                self.polygon or ())


@dataclass(frozen=True)
class CanonicalProgram:
    """A validated, canonically-ordered program ready for bucketing."""

    token: str
    name: str
    alert_type: str
    alert_level: int
    clauses: Tuple[Tuple[CanonicalPred, ...], ...]
    doc: str = ""  # original JSON doc (checkpoint round-trip carrier)

    @property
    def n_clauses(self) -> int:
        return len(self.clauses)

    @property
    def max_preds(self) -> int:
        return max(len(c) for c in self.clauses)

    def structure_key(self) -> str:
        return structure_key(self)


def _bucket(n: int, rungs: Sequence[int], what: str) -> int:
    for r in rungs:
        if n <= r:
            return r
    raise RuleProgramError(f"{what} count {n} exceeds the maximum "
                           f"{rungs[-1]}")


def structure_key(prog: CanonicalProgram) -> str:
    """The bucketed shape identity: ``c{C}p{P}`` plus a ``g`` suffix when
    the geofence lane is live.  Constants never appear here — that is the
    whole hot-swap contract."""
    c = _bucket(prog.n_clauses, CLAUSE_BUCKETS, "clause")
    p = _bucket(prog.max_preds, PRED_BUCKETS, "predicate")
    geo = any(pr.kind == PK_GEO for cl in prog.clauses for pr in cl)
    return f"c{c}p{p}" + ("g" if geo else "")


def snap_window_idx(window_s: float,
                    halflives_s: Sequence[float] = DEFAULT_EWMA_HALFLIVES_S
                    ) -> int:
    """Snap a requested EWMA window to the nearest shared timescale.

    The trailing state carries one EWMA per shared halflife (exactly the
    ``DeviceState`` contract) — per-program timescales would turn the
    window choice into a *shape* and defeat bucketing, so the window is
    an operand: an index into the shared ladder."""
    if not (window_s > 0):
        raise RuleProgramError(f"window_s must be > 0, got {window_s!r}")
    return int(min(range(len(halflives_s)),
                   key=lambda i: abs(math.log(window_s)
                                     - math.log(halflives_s[i]))))


def _parse_pred(doc: dict, resolve_mtype, resolve_attr) -> CanonicalPred:
    if not isinstance(doc, dict) or "pred" not in doc:
        raise RuleProgramError(f"predicate must be an object with a "
                               f"'pred' field, got {doc!r}")
    kind = _PRED_NAMES.get(doc["pred"])
    if kind is None:
        raise RuleProgramError(
            f"unknown predicate {doc['pred']!r} (one of "
            f"{sorted(_PRED_NAMES)})")

    def op_of(default: Optional[str] = None) -> int:
        raw = doc.get("op", default)
        if raw not in _OP_NAMES:
            raise RuleProgramError(f"unknown op {raw!r} (one of "
                                   f"{sorted(_OP_NAMES)})")
        return int(_OP_NAMES[raw])

    if kind in (PK_VALUE, PK_EWMA, PK_RATE):
        if "value" not in doc:
            raise RuleProgramError(f"{doc['pred']!r} predicate needs a "
                                   "numeric 'value' threshold")
        thr = float(doc["value"])
        mtype = NULL_ID
        if doc.get("mtype") is not None:
            if resolve_mtype is None:
                raise RuleProgramError("mtype filters need a measurement-"
                                       "type resolver")
            mtype = int(resolve_mtype(str(doc["mtype"])))
        widx = 0
        if kind == PK_EWMA:
            widx = snap_window_idx(float(doc.get("window_s", 0) or 0))
        return CanonicalPred(kind=kind, op=op_of(), f0=thr, i0=mtype,
                             i1=widx)

    if kind == PK_GEO:
        poly = doc.get("polygon")
        if (not isinstance(poly, (list, tuple)) or len(poly) < 3
                or len(poly) > MAX_POLY_VERTS
                or not all(isinstance(v, (list, tuple)) and len(v) == 2
                           for v in poly)):
            raise RuleProgramError(
                "geo predicate needs 'polygon': [[lon, lat] x 3.."
                f"{MAX_POLY_VERTS}]")
        inside = bool(doc.get("inside", True))
        ring = tuple((float(v[0]), float(v[1])) for v in poly)
        return CanonicalPred(kind=kind, i0=1 if inside else 0,
                             polygon=ring)

    if kind == PK_ATTR:
        table = _ATTR_TABLES.get(doc.get("table", "device"))
        if table is None:
            raise RuleProgramError(f"attr table must be one of "
                                   f"{sorted(_ATTR_TABLES)}")
        col_name = doc.get("column")
        if not col_name:
            raise RuleProgramError("attr predicate needs a 'column' name")
        if resolve_attr is None:
            raise RuleProgramError("attr predicates need an attribute-"
                                   "column resolver")
        col = int(resolve_attr(
            "device" if table == ATTR_TABLE_DEVICE else "asset",
            str(col_name)))
        if "value" not in doc:
            raise RuleProgramError("attr predicate needs an integer "
                                   "'value' to compare against")
        return CanonicalPred(kind=kind, op=op_of("eq"),
                             i0=int(doc["value"]), i1=col, i2=table)

    # PK_EVENT_TYPE
    et = _EVENT_TYPE_NAMES.get(str(doc.get("value", "")).lower())
    if et is None:
        raise RuleProgramError(
            f"event_type predicate value must be one of "
            f"{sorted(_EVENT_TYPE_NAMES)} (alert events are reserved "
            "for the derived-alert path)")
    return CanonicalPred(kind=PK_EVENT_TYPE, op=op_of("eq"), i0=et)


def _normalize_when(when) -> List[List[dict]]:
    """Normalize ``when`` to DNF clause lists; reject deeper nesting."""
    if isinstance(when, dict) and "any" in when:
        clauses = when["any"]
        if not isinstance(clauses, (list, tuple)) or not clauses:
            raise RuleProgramError("'any' needs a non-empty clause list")
        out = []
        for cl in clauses:
            if isinstance(cl, dict) and "all" in cl:
                preds = cl["all"]
            elif isinstance(cl, dict) and "any" in cl:
                raise RuleProgramError("nested 'any' is not supported — "
                                       "flatten to one level of any-of-all")
            else:
                preds = [cl]
            if not isinstance(preds, (list, tuple)) or not preds:
                raise RuleProgramError("'all' needs a non-empty "
                                       "predicate list")
            out.append(list(preds))
        return out
    if isinstance(when, dict) and "all" in when:
        preds = when["all"]
        if not isinstance(preds, (list, tuple)) or not preds:
            raise RuleProgramError("'all' needs a non-empty predicate list")
        if any(isinstance(p, dict) and ("any" in p or "all" in p)
               for p in preds):
            raise RuleProgramError("nested combinators inside 'all' are "
                                   "not supported")
        return [list(preds)]
    if isinstance(when, dict) and "pred" in when:
        return [[when]]
    raise RuleProgramError("'when' must be a predicate, {'all': [...]} "
                           "or {'any': [{'all': [...]} ...]}")


def parse_program(doc: dict,
                  resolve_mtype: Optional[Callable[[str], int]] = None,
                  resolve_attr: Optional[Callable[[str, str], int]] = None,
                  ) -> CanonicalProgram:
    """Validate + canonicalize one program doc.

    Raises :class:`RuleProgramError` on any malformed field so a bad
    spec fails the POST, never the first traffic batch (the same
    compile-at-registration contract as ``analytics.runner.register``).
    """
    if not isinstance(doc, dict):
        raise RuleProgramError("program must be a JSON object")
    token = str(doc.get("token") or "").strip()
    if not token:
        raise RuleProgramError("program needs a non-empty 'token'")
    alert = doc.get("alert")
    if not isinstance(alert, dict) or not alert.get("type"):
        raise RuleProgramError("program needs 'alert': {'type': ..., "
                               "'level': ...}")
    level = _LEVEL_NAMES.get(str(alert.get("level", "warning")).lower())
    if level is None:
        raise RuleProgramError(f"alert level must be one of "
                               f"{sorted(_LEVEL_NAMES)}")

    raw_clauses = _normalize_when(doc.get("when"))
    if len(raw_clauses) > MAX_CLAUSES:
        raise RuleProgramError(f"{len(raw_clauses)} clauses exceeds the "
                               f"maximum {MAX_CLAUSES}")
    clauses: List[Tuple[CanonicalPred, ...]] = []
    for cl in raw_clauses:
        if len(cl) > MAX_PREDS:
            raise RuleProgramError(f"{len(cl)} predicates in one clause "
                                   f"exceeds the maximum {MAX_PREDS}")
        preds = sorted((_parse_pred(p, resolve_mtype, resolve_attr)
                        for p in cl), key=CanonicalPred.sort_key)
        clauses.append(tuple(preds))
    clauses.sort(key=lambda c: tuple(p.sort_key() for p in c))

    return CanonicalProgram(
        token=token,
        name=str(doc.get("name", token)),
        alert_type=str(alert["type"]),
        alert_level=int(level),
        clauses=tuple(clauses),
        doc=json.dumps(doc, sort_keys=True),
    )


def describe_program(prog: CanonicalProgram) -> Dict[str, object]:
    """REST body for one registered program."""
    return {
        "token": prog.token,
        "name": prog.name,
        "alert": {"type": prog.alert_type,
                  "level": AlertLevel(prog.alert_level).name.lower()},
        "structure": prog.structure_key(),
        "clauses": prog.n_clauses,
        "predicates": sum(len(c) for c in prog.clauses),
        "doc": json.loads(prog.doc) if prog.doc else None,
    }


__all__ = [
    "MAX_CLAUSES", "MAX_PREDS", "CLAUSE_BUCKETS", "PRED_BUCKETS",
    "MAX_POLY_VERTS", "MAX_STRUCTURE_KEYS",
    "PK_PAD", "PK_VALUE", "PK_EWMA", "PK_RATE", "PK_GEO", "PK_ATTR",
    "PK_EVENT_TYPE", "ATTR_TABLE_DEVICE", "ATTR_TABLE_ASSET",
    "RuleProgramError", "CanonicalPred", "CanonicalProgram",
    "parse_program", "describe_program", "structure_key",
    "snap_window_idx",
]
