"""Host-side rule management: CRUD over vectorized threshold rules.

Counterpart of ``ThresholdRule`` and ``RuleManager`` in
``sitewhere_tpu/pipeline/rules.py`` (:46-249).  The manager owns the
authoritative rule records on the host and publishes a fresh
:class:`~sitewhere_tpu_torch.schema.RuleTable` epoch on its device when a
mutation made it dirty, the same double-buffered pattern as
:class:`~sitewhere_tpu_torch.services.device_management.RegistryMirror`.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional

import numpy as np
import torch

from sitewhere_tpu_torch.device import DeviceLike, resolve_device
from sitewhere_tpu_torch.ids import NULL_ID, IdentityMap
from sitewhere_tpu_torch.schema import (
    DEFAULT_EWMA_HALFLIVES_S,
    AlertLevel,
    ComparisonOp,
    RuleKind,
    RuleTable,
    pow2_at_least,
)
from sitewhere_tpu_torch.services.common import (
    DuplicateToken,
    EntityNotFound,
    ValidationError,
    mint_token,
    now_s,
    require,
)


@dataclasses.dataclass
class ThresholdRule:
    """One declarative threshold rule (host record)."""

    _PICKLE_AS = ("sitewhere_tpu.pipeline.rules", "ThresholdRule")

    token: str
    mtype: Optional[str]          # measurement name; None = all
    op: ComparisonOp
    threshold: float
    alert_type: str               # alert code to fire
    alert_level: AlertLevel = AlertLevel.WARNING
    tenant: Optional[str] = None  # None = all tenants
    # what quantity to compare (instantaneous / trailing EWMA / rate)
    kind: RuleKind = RuleKind.INSTANT
    # requested averaging window for WINDOW_MEAN — snapped to the nearest
    # shared EWMA time-scale (window_idx) at publish
    window_s: Optional[float] = None
    created_s: int = dataclasses.field(default_factory=now_s)


class RuleManager:
    """Threshold-rule catalog publishing :class:`RuleTable` epochs."""

    def __init__(self, identity: IdentityMap, capacity: int = 256,
                 ewma_halflives_s: tuple = None, device: DeviceLike = None):
        self.device = resolve_device(device)
        if ewma_halflives_s is None:
            ewma_halflives_s = DEFAULT_EWMA_HALFLIVES_S
        self.identity = identity
        self.capacity = capacity
        self.ewma_halflives_s = tuple(float(t) for t in ewma_halflives_s)
        self._lock = threading.RLock()
        self._rules: Dict[str, ThresholdRule] = {}
        self._slots: Dict[str, int] = {}
        self._free: List[int] = list(range(capacity - 1, -1, -1))
        self._dirty = True
        self._epoch = 0
        self._table: Optional[RuleTable] = None

    # -- CRUD ---------------------------------------------------------------

    def create_rule(
        self,
        mtype: Optional[str],
        op: ComparisonOp,
        threshold: float,
        alert_type: str,
        alert_level: AlertLevel = AlertLevel.WARNING,
        tenant: Optional[str] = None,
        token: Optional[str] = None,
        kind: RuleKind = RuleKind.INSTANT,
        window_s: Optional[float] = None,
    ) -> ThresholdRule:
        require(bool(alert_type), ValidationError("alert_type required"))
        kind = RuleKind(kind)
        if kind == RuleKind.WINDOW_MEAN:
            require(window_s is not None and window_s > 0,
                    ValidationError("WINDOW_MEAN rule needs window_s > 0"))
        with self._lock:
            token = token or mint_token("rule")
            require(token not in self._rules, DuplicateToken(f"rule {token!r}"))
            require(bool(self._free), ValidationError("rule table full"))
            rule = ThresholdRule(
                token=token,
                mtype=mtype,
                op=ComparisonOp(op),
                threshold=float(threshold),
                alert_type=alert_type,
                alert_level=AlertLevel(alert_level),
                tenant=tenant,
                kind=kind,
                window_s=float(window_s) if window_s is not None else None,
            )
            self._rules[token] = rule
            self._slots[token] = self._free.pop()
            self._dirty = True
            return rule

    def get_rule(self, token: str) -> ThresholdRule:
        with self._lock:
            rule = self._rules.get(token)
            require(rule is not None, EntityNotFound(f"no rule {token!r}"))
            return rule

    def list_rules(self, tenant: Optional[str] = None) -> List[ThresholdRule]:
        with self._lock:
            return [
                r
                for r in self._rules.values()
                if tenant is None or r.tenant in (None, tenant)
            ]

    def update_rule(self, token: str, **fields) -> ThresholdRule:
        """Mutate a rule; the next publish rebuilds the table (reference:
        rule processors are reconfigured through tenant config updates +
        engine restart — here it's one epoch swap).

        Stage-validate-then-apply: a bad field leaves the rule (and the
        publishable catalog) completely untouched.
        """
        allowed = {"mtype", "op", "threshold", "alert_type", "alert_level",
                   "tenant", "kind", "window_s"}
        unknown = set(fields) - allowed
        require(not unknown, ValidationError(f"unknown fields {sorted(unknown)}"))
        staged = {}
        try:
            for k, v in fields.items():
                if k == "op":
                    v = ComparisonOp(v)
                elif k == "alert_level":
                    v = AlertLevel(v)
                elif k == "kind":
                    v = RuleKind(v)
                elif k == "threshold":
                    v = float(v)  # None rejected: publish needs a number
                elif k == "window_s" and v is not None:
                    v = float(v)
                staged[k] = v
        except (TypeError, ValueError) as e:
            raise ValidationError(f"bad value for {k!r}: {e}") from e
        if "alert_type" in staged:
            require(bool(staged["alert_type"]),
                    ValidationError("alert_type required"))
        with self._lock:
            rule = self.get_rule(token)
            kind = staged.get("kind", rule.kind)
            window_s = staged.get("window_s", rule.window_s)
            if kind == RuleKind.WINDOW_MEAN:
                require(window_s is not None and window_s > 0,
                        ValidationError("WINDOW_MEAN rule needs window_s > 0"))
            for k, v in staged.items():
                setattr(rule, k, v)
            self._dirty = True
            return rule

    def delete_rule(self, token: str) -> ThresholdRule:
        with self._lock:
            rule = self.get_rule(token)
            del self._rules[token]
            self._free.append(self._slots.pop(token))
            self._dirty = True
            return rule

    # -- epoch publication --------------------------------------------------

    @property
    def dirty(self) -> bool:
        with self._lock:
            return self._dirty

    def _tensor(self, rows: np.ndarray) -> torch.Tensor:
        return torch.tensor(rows, device=self.device)

    def publish(self) -> RuleTable:
        """Current :class:`RuleTable` epoch on the manager's device
        (rebuilt only when dirty)."""
        with self._lock:
            if not self._dirty and self._table is not None:
                return self._table
            # Size at the smallest power of two covering every used slot
            # (slots allocate low-first): an empty/small rule set must
            # not make every step pay the full-capacity [B, R] pass.
            hi = (max(self._slots.values()) + 1) if self._slots else 0
            trim = pow2_at_least(hi, cap=self.capacity)
            active = np.zeros(trim, bool)
            tenant_id = np.full(trim, NULL_ID, np.int32)
            mtype_id = np.full(trim, NULL_ID, np.int32)
            op = np.zeros(trim, np.int32)
            threshold = np.zeros(trim, np.float32)
            alert_code = np.full(trim, NULL_ID, np.int32)
            alert_level = np.zeros(trim, np.int32)
            kind = np.zeros(trim, np.int32)
            window_idx = np.zeros(trim, np.int32)
            halflives = np.asarray(self.ewma_halflives_s, np.float32)
            # operator-facing half-lives → e-folding taus (alpha uses
            # exp(-dt/tau); after one half-life the old average must
            # retain exactly 50%)
            taus = halflives / np.log(2.0)
            for token, rule in self._rules.items():
                slot = self._slots[token]
                active[slot] = True
                if rule.tenant is not None:
                    tenant_id[slot] = self.identity.tenant.mint(rule.tenant)
                if rule.mtype is not None:
                    mtype_id[slot] = self.identity.mtype.mint(rule.mtype)
                op[slot] = int(rule.op)
                threshold[slot] = rule.threshold
                alert_code[slot] = self.identity.alert_type.mint(rule.alert_type)
                alert_level[slot] = int(rule.alert_level)
                kind[slot] = int(rule.kind)
                if rule.window_s is not None:
                    # snap to the nearest shared half-life
                    window_idx[slot] = int(np.argmin(
                        np.abs(halflives - float(rule.window_s))))
            t = self._tensor
            self._table = RuleTable(
                active=t(active),
                tenant_id=t(tenant_id),
                mtype_id=t(mtype_id),
                op=t(op),
                threshold=t(threshold),
                alert_code=t(alert_code),
                alert_level=t(alert_level),
                kind=t(kind),
                window_idx=t(window_idx),
                # float32, as the reference's jnp.asarray makes it
                ewma_tau_s=t(taus.astype(np.float32)),
            )
            self._dirty = False
            self._epoch += 1
            return self._table
