"""The deployment's world: registry, threshold rules and zones, made on
the device from ``--seed``.

Frozen copies: ``random_polygons`` is ``chip_smoke.py:654``; the tables
follow ``make_world`` (``chip_smoke.py:740``) for the registry and
``populate_world`` / ``make_wire_world`` (``chip_smoke.py:1105-1176``)
for rule thresholds and zone conditions, where real alerts are rare:
instant rules below 0.1 or above 99.9, window means above 99, rates
above 95/s, every zone ALERT_IF_INSIDE.  One tenant (0).

The tables are plain dicts of tensors whose fields and codes are those of
the port's ``Registry``, ``RuleTable`` and ``ZoneTable``; the driver hands
them to the port, the reference reads them as they are.  Rule alert codes
are ``1000 + r`` and zone codes ``2000 + z``, at or above
``generator.DERIVED_CODE_MIN``.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

NULL_ID = -1
ASSIGNMENT_ACTIVE = 1
# ComparisonOp: GT 0, LT 1, GTE 2, LTE 3, EQ 4, NEQ 5; RuleKind: INSTANT 0,
# WINDOW_MEAN 1, RATE_PER_S 2; ZoneCondition: ALERT_IF_INSIDE 0
OP_GT, OP_LT = 0, 1
KIND_INSTANT, KIND_WINDOW_MEAN, KIND_RATE = 0, 1, 2
ZONE_INSIDE = 0


def random_polygons(gen, z, v, lo, hi, rmin, rmax, device):
    """``z`` random convex polygons of 3..v vertices in the box
    ``[lo, hi]^2``, padded to ``v`` by repeating the last vertex."""
    n = torch.randint(3, v + 1, (z,), generator=gen, device=device)
    ang = torch.sort(torch.rand((z, v), generator=gen, device=device)
                     * (2 * math.pi), dim=1).values
    keep = torch.minimum(torch.arange(v, device=device)[None, :], n[:, None] - 1)
    ang = torch.gather(ang, 1, keep)
    center = lo + (hi - lo) * torch.rand((z, 1, 2), generator=gen, device=device)
    radius = rmin + (rmax - rmin) * torch.rand((z, 1), generator=gen,
                                               device=device)
    ring = torch.stack([torch.cos(ang), torch.sin(ang)], dim=-1) * radius[..., None]
    return (center + ring).to(torch.float32).contiguous()


def make_world(cfg: Dict, seed: int, device) -> Dict[str, Dict[str, torch.Tensor]]:
    """``{"registry": ..., "rules": ..., "zones": ...}`` on ``device``."""
    cap, n_dev = cfg["registry_capacity"], cfg["devices"]
    ids = torch.arange(cap, dtype=torch.int32, device=device)
    on = ids < n_dev
    null = torch.full_like(ids, NULL_ID)
    registry = dict(
        active=on,
        tenant_id=torch.where(on, 0, null),
        device_type_id=torch.where(on, ids % 16, null),
        assignment_id=torch.where(on, ids, null),
        assignment_status=torch.where(on, ASSIGNMENT_ACTIVE, 0).to(torch.int32),
        area_id=torch.where(on, ids % 64, null),
        customer_id=torch.where(on, ids % 1000, null),
        asset_id=torch.where(on, ids % 5000, null),
        epoch=torch.zeros((), dtype=torch.int32, device=device),
    )

    n_rules = cfg["rules"]
    r = torch.arange(n_rules, dtype=torch.int32, device=device)
    kind = (r % 3).to(torch.int32)
    odd = (r % 2) == 1
    op = torch.where((kind == KIND_INSTANT) & ~odd, OP_LT, OP_GT).to(torch.int32)
    threshold = torch.where(
        kind == KIND_INSTANT, torch.where(odd, 99.9, 0.1),
        torch.where(kind == KIND_WINDOW_MEAN, 99.0, 95.0)).to(torch.float32)
    rules = dict(
        active=torch.ones(n_rules, dtype=torch.bool, device=device),
        tenant_id=torch.where(odd, 0, NULL_ID).to(torch.int32),
        mtype_id=(r % cfg["mtype_slots"]).to(torch.int32),
        op=op,
        threshold=threshold,
        alert_code=(1000 + r).to(torch.int32),
        alert_level=(r % 4).to(torch.int32),
        kind=kind,
        window_idx=(r % len(cfg["ewma_taus_s"])).to(torch.int32),
        ewma_tau_s=torch.tensor(cfg["ewma_taus_s"], dtype=torch.float32,
                                device=device),
    )

    n_zones, n_verts = cfg["zones"], cfg["zone_verts"]
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    lo, hi = cfg["zone_box"]
    rmin, rmax = cfg["zone_radius"]
    z = torch.arange(n_zones, dtype=torch.int32, device=device)
    zones = dict(
        active=torch.ones(n_zones, dtype=torch.bool, device=device),
        tenant_id=torch.where(z % 2 == 1, NULL_ID, 0).to(torch.int32),
        area_id=torch.where(z % 4 == 3, z % 64, NULL_ID).to(torch.int32),
        verts=random_polygons(gen, n_zones, n_verts, lo, hi, rmin, rmax,
                              device),
        nvert=torch.full((n_zones,), n_verts, dtype=torch.int32, device=device),
        condition=torch.full((n_zones,), ZONE_INSIDE, dtype=torch.int32,
                             device=device),
        alert_code=(2000 + z).to(torch.int32),
        alert_level=(z % 4).to(torch.int32),
    )
    return {"registry": registry, "rules": rules, "zones": zones}


def to_host(world) -> Dict[str, Dict]:
    """The world as NumPy arrays (the reference's copy of the inputs)."""
    return {k: {f: t.cpu().numpy() for f, t in tab.items()}
            for k, tab in world.items()}
