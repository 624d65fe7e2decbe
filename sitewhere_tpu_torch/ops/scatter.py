"""Masked, time-ordered scatters: newest-wins merges of a batch into
per-slot state.

Counterpart of ``sitewhere_tpu/ops/scatter.py`` in its scatter form
(``_winner_rows_scatter`` :57); the sort form (:28) waits for an H100
measurement that calls for it.  Each slot takes the row with the newest
key, tie-broken by batch row index (highest row wins), so exactly one
event row writes all of a slot's payload columns.

Out-of-range ids are dropped, as ``mode="drop"`` does in JAX: every
scatter here writes into a buffer of ``capacity + 1`` entries whose last
entry is a dump slot for masked and out-of-range rows, then slices it
off.  (Torch index ops raise on an out-of-range index on the CPU and
write out of bounds on CUDA.)
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

INT32_MIN = -(1 << 31)


def _dump_index(ids: torch.Tensor, keep: torch.Tensor,
                capacity: int) -> torch.Tensor:
    """int64 scatter index: ``ids`` where ``keep``, else the dump slot."""
    return torch.where(keep, ids, capacity).to(torch.int64)


def winner_rows_by_keys(
    ids: torch.Tensor,
    keys: Sequence[torch.Tensor],
    mask: torch.Tensor,
    capacity: int,
) -> torch.Tensor:
    """Per-slot winning batch row (max lexicographic key, highest row on
    ties): ``int32[capacity]``, ``-1`` where no masked row targets the
    slot.

    Lexicographic multi-pass scatter-max: pass k keeps the rows whose key
    equals the per-slot max among rows that survived passes 0..k-1; a
    final scatter-max of the row index breaks the remaining ties.
    """
    won = mask & (ids >= 0) & (ids < capacity)
    clip_ids = ids.clamp(0, capacity - 1).to(torch.int64)
    for k in keys:
        mx = torch.full((capacity + 1,), INT32_MIN, dtype=torch.int32,
                        device=ids.device)
        mx.scatter_reduce_(0, _dump_index(ids, won, capacity), k, "amax",
                           include_self=True)
        won = won & (k == mx[clip_ids])
    rows = torch.arange(ids.shape[0], dtype=torch.int32, device=ids.device)
    out = torch.full((capacity + 1,), -1, dtype=torch.int32, device=ids.device)
    out.scatter_reduce_(0, _dump_index(ids, won, capacity), rows, "amax",
                        include_self=True)
    return out[:capacity]


def winner_rows(
    ids: torch.Tensor,
    ts_s: torch.Tensor,
    ts_ns: torch.Tensor,
    mask: torch.Tensor,
    capacity: int,
) -> torch.Tensor:
    """Per-slot winning row by newest ``(ts_s, ts_ns)``, highest row on ties."""
    return winner_rows_by_keys(ids, (ts_s, ts_ns), mask, capacity)


def _per_slot(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``bool[capacity]`` reshaped to broadcast against ``like``."""
    return mask.reshape(mask.shape + (1,) * (like.ndim - 1))


def apply_winners(
    slot_row: torch.Tensor,
    cur_ts_s: torch.Tensor,
    cur_ts_ns: torch.Tensor,
    cur_payload: Sequence[torch.Tensor],
    ts_s: torch.Tensor,
    ts_ns: torch.Tensor,
    payload: Sequence[torch.Tensor],
) -> Tuple[torch.Tensor, torch.Tensor, Tuple[torch.Tensor, ...]]:
    """Apply a :func:`winner_rows` map: update the slots whose winning
    event is at least as new as the slot's current key (events win exact
    ties)."""
    has = slot_row >= 0
    wr = slot_row.clamp_min(0).to(torch.int64)
    w_s = ts_s[wr]
    w_ns = ts_ns[wr]
    newer = has & ((w_s > cur_ts_s) | ((w_s == cur_ts_s) & (w_ns >= cur_ts_ns)))
    new_s = torch.where(newer, w_s, cur_ts_s)
    new_ns = torch.where(newer, w_ns, cur_ts_ns)
    out = tuple(torch.where(_per_slot(newer, cur), val[wr].to(val.dtype), cur)
                for cur, val in zip(cur_payload, payload))
    return new_s, new_ns, out


def _check_arity(cur_payload, payload) -> None:
    if len(cur_payload) != len(payload):
        raise ValueError(
            f"payload arity mismatch: {len(cur_payload)} state arrays vs "
            f"{len(payload)} event arrays (pass tuples, not bare arrays)")


def scatter_last_by_time(
    cur_ts_s: torch.Tensor,
    cur_ts_ns: torch.Tensor,
    cur_payload: Sequence[torch.Tensor],
    ids: torch.Tensor,
    ts_s: torch.Tensor,
    ts_ns: torch.Tensor,
    payload: Sequence[torch.Tensor],
    mask: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, Tuple[torch.Tensor, ...]]:
    """Scatter ``payload`` rows into per-id slots, newest ``(ts_s, ts_ns)``
    wins; rows with ``mask=False`` or out-of-range ids are dropped."""
    _check_arity(cur_payload, payload)
    slot_row = winner_rows(ids, ts_s, ts_ns, mask, cur_ts_s.shape[0])
    return apply_winners(
        slot_row, cur_ts_s, cur_ts_ns, cur_payload, ts_s, ts_ns, payload)


def scatter_max_by_key(
    cur_key: torch.Tensor,
    cur_payload: Sequence[torch.Tensor],
    ids: torch.Tensor,
    key: torch.Tensor,
    payload: Sequence[torch.Tensor],
    mask: torch.Tensor,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """Single-key (seconds-only) variant of :func:`scatter_last_by_time`."""
    _check_arity(cur_payload, payload)
    slot_row = winner_rows_by_keys(ids, (key,), mask, cur_key.shape[0])
    has = slot_row >= 0
    wr = slot_row.clamp_min(0).to(torch.int64)
    w_key = key[wr]
    newer = has & (w_key >= cur_key)
    new_key = torch.where(newer, w_key, cur_key)
    out = tuple(torch.where(_per_slot(newer, cur), val[wr], cur)
                for cur, val in zip(cur_payload, payload))
    return new_key, out


def bincount_fixed(ids: torch.Tensor, mask: torch.Tensor,
                   length: int) -> torch.Tensor:
    """Masked bincount with a fixed length (ids outside ``[0, length)``
    count nowhere): ``int32[length]``."""
    hit = (ids[:, None] == torch.arange(length, dtype=ids.dtype,
                                        device=ids.device)[None, :])
    return (hit & mask[:, None]).sum(dim=0, dtype=torch.int32)
