"""Cross-layer bucketing: K-factors (and preconditioned taps) of one shape
class are stacked into one batch, so the optimizer's hot path runs
O(#shape-classes) batched launches instead of O(#layers) small ones.

Counterpart of ``src/repro/core/buckets.py``, replicated part:
factor buckets are keyed on the full ``KFactorSpec``, precond buckets on
(A-spec, G-spec, linear_apply); bucket and entry order is deterministic
(sorted tap name, then side).  The shard-aware layout helpers at the
end are the reference's index bookkeeping for the distributed curvature
engine (``distributed/curvature.py``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Sequence, Tuple

import torch

from repro_torch.core.kfactor import KFactorSpec, KFactorState

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class Entry:
    """One (tap, side) slot range inside a bucket's flat batch axis."""
    name: str
    side: str                    # "A" | "G" (factor buckets); "" (precond)
    stack: Tuple[int, ...]
    offset: int
    count: int


@dataclasses.dataclass(frozen=True)
class FactorBucket:
    spec: KFactorSpec
    entries: Tuple[Entry, ...]
    total: int


@dataclasses.dataclass(frozen=True)
class PrecondBucket:
    spec_a: KFactorSpec
    spec_g: KFactorSpec
    linear_apply: bool
    entries: Tuple[Entry, ...]
    total: int


def _count(stack: Tuple[int, ...]) -> int:
    return math.prod(stack) if stack else 1


def build_factor_buckets(specs: Dict[str, Dict[str, KFactorSpec]],
                         stacks: Dict[str, Tuple[int, ...]]
                         ) -> Tuple[FactorBucket, ...]:
    """Group every (tap, side) factor job by its KFactorSpec."""
    grouped: Dict[KFactorSpec, list] = {}
    for name in sorted(specs):
        for side in ("A", "G"):
            grouped.setdefault(specs[name][side], []).append((name, side))
    buckets = []
    for spec in sorted(grouped, key=lambda s: (s.d, s.n_stat, s.mode.value,
                                               s.r, s.n_crc)):
        entries, offset = [], 0
        for name, side in grouped[spec]:
            count = _count(stacks[name])
            entries.append(Entry(name=name, side=side, stack=stacks[name],
                                 offset=offset, count=count))
            offset += count
        buckets.append(FactorBucket(spec=spec, entries=tuple(entries),
                                    total=offset))
    return tuple(buckets)


def build_precond_buckets(specs: Dict[str, Dict[str, KFactorSpec]],
                          stacks: Dict[str, Tuple[int, ...]],
                          linear_apply: Dict[str, bool]
                          ) -> Tuple[PrecondBucket, ...]:
    """Group taps by (A-spec, G-spec, linear_apply)."""
    grouped: Dict[tuple, list] = {}
    for name in sorted(specs):
        key = (specs[name]["A"], specs[name]["G"], linear_apply[name])
        grouped.setdefault(key, []).append(name)
    buckets = []
    for key in sorted(grouped, key=lambda k: (k[0].d, k[1].d, k[2])):
        spec_a, spec_g, lin = key
        entries, offset = [], 0
        for name in grouped[key]:
            count = _count(stacks[name])
            entries.append(Entry(name=name, side="", stack=stacks[name],
                                 offset=offset, count=count))
            offset += count
        buckets.append(PrecondBucket(spec_a=spec_a, spec_g=spec_g,
                                     linear_apply=lin,
                                     entries=tuple(entries), total=offset))
    return tuple(buckets)


# ---------------------------------------------------------------------------
# gather / scatter
# ---------------------------------------------------------------------------

def _flatten(x: Tensor, entry: Entry) -> Tensor:
    """(*entry.stack, *core) → (count, *core)."""
    return x.reshape((entry.count,) + tuple(x.shape[len(entry.stack):]))


def _unflatten(x: Tensor, entry: Entry) -> Tensor:
    """(count, *core) → (*entry.stack, *core)."""
    return x.reshape(tuple(entry.stack) + tuple(x.shape[1:]))


def gather(entries: Sequence[Entry], leaves: Dict[Tuple[str, str], Tensor]
           ) -> Tensor:
    """Stack per-entry tensors {(name, side): (*stack, *core)} into one
    (total, *core) batch (a view when the bucket has one entry)."""
    parts = [_flatten(leaves[(e.name, e.side)], e) for e in entries]
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=0)


def scatter(entries: Sequence[Entry], batched: Tensor
            ) -> Dict[Tuple[str, str], Tensor]:
    """Split a (total, *core) bucket result back into per-entry tensors."""
    return {(e.name, e.side):
            _unflatten(batched[e.offset:e.offset + e.count], e)
            for e in entries}


def gather_states(entries: Sequence[Entry],
                  states: Dict[Tuple[str, str], KFactorState]
                  ) -> KFactorState:
    """Field-wise gather of KFactorStates into one (total, …) state."""
    sts = [states[(e.name, e.side)] for e in entries]
    field = lambda f: gather(entries, {(e.name, e.side): getattr(s, f)
                                       for e, s in zip(entries, sts)})
    return KFactorState(U=field("U"), D=field("D"), M=field("M"),
                        aux=field("aux"))


def scatter_states(entries: Sequence[Entry], batched: KFactorState
                   ) -> Dict[Tuple[str, str], KFactorState]:
    """Field-wise split of a bucket state back to per-entry states."""
    return {(e.name, e.side): batched.map(
                lambda leaf, e=e: _unflatten(
                    leaf[e.offset:e.offset + e.count], e))
            for e in entries}


# ---------------------------------------------------------------------------
# shard-aware layout: round-robin slot → device assignment (KAISA-style)
# ---------------------------------------------------------------------------
#
# The distributed curvature engine partitions a bucket's flat batch axis
# across the mesh's curvature axis.  Slot s lives on device s % n at local
# row s // n, so consecutive slots (usually one stacked tap) spread across
# devices and every device gets an equal ceil(total/n) share of every
# bucket.  Pure index bookkeeping, as in the reference.

def padded_total(total: int, n: int) -> int:
    """Bucket batch padded to a multiple of the device count."""
    return -(-total // n) * n


def shard_perm(total: int, n: int):
    """Index vector placing slots device-major: position d*m + k holds
    slot (k*n + d) % total; the pad tail wraps onto real slots, so
    padding computes on well-formed (discarded) operands."""
    m = padded_total(total, n) // n
    return [(k * n + d) % total for d in range(n) for k in range(m)]


def shard_unperm(total: int, n: int):
    """Inverse map: position of slot s in the device-major layout."""
    m = padded_total(total, n) // n
    return [(s % n) * m + s // n for s in range(total)]


def slot_device(slot: int, n: int) -> int:
    """Owning device of a bucket slot under the round-robin assignment."""
    return slot % n


def localize_ranges(ranges, total: int, n: int):
    """Global heavy slot ranges → the per-device local row ranges (equal
    on every device).  Each range must start at a multiple of ``n`` and
    end at a multiple of ``n`` or at the bucket end (the scheduler's
    ``align=n`` contract); rows past ``total`` fall on wrapped pad slots
    whose results are discarded."""
    local = []
    for lo, hi in ranges:
        if lo % n != 0 or (hi % n != 0 and hi != total):
            raise ValueError(
                f"heavy range ({lo}, {hi}) not aligned to the curvature "
                f"mesh size {n}; build the Scheduler with align={n}")
        local.append((lo // n, -(-hi // n)))
    return tuple(local)
