"""The K-FAC work scheduler: static per-step work masks, with optional
*staggering* of the heavy inverse recomputations.

Counterpart of ``src/repro/core/schedule.py`` (a copy: the port imports
nothing of the reference).  ``stats``/``light`` are global per step; heavy
work is per factor bucket as slot ranges.  The :class:`Scheduler` gives
each unit (a bucket, or an entry-aligned chunk of one) a phase spread over
the heavy period, snapped to multiples of ``T_brand`` for Brand-family
buckets (pinned to 0 when ``T_brand`` does not divide the period), fires
every unit at step 0 (warmup), and gives the dense buckets of a pure-Brand
variant a warmup-only unit.  The async pipeline is a later slice, so the
``launch``/``land`` ranges are always empty here.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

from repro_torch.core import policy as policy_lib

Ranges = Tuple[Tuple[int, int], ...]


@dataclasses.dataclass(frozen=True)
class StepWork:
    """Static work mask for one optimizer step (hashable)."""
    stats: bool
    light: bool
    heavy: Tuple[Ranges, ...]
    launch: Tuple[Ranges, ...] = ()
    land: Tuple[Ranges, ...] = ()

    @property
    def any_heavy(self) -> bool:
        return any(self.heavy)

    @property
    def any_async(self) -> bool:
        return any(self.launch) or any(self.land)

    @property
    def any(self) -> bool:
        return self.stats or self.light or self.any_heavy or self.any_async

    @property
    def label(self) -> str:
        """One-word phase class: the heaviest work class this step runs."""
        if self.any_heavy or any(self.land):
            return "heavy"
        if any(self.launch):
            return "launch"
        if self.light:
            return "light"
        if self.stats:
            return "stats"
        return "idle"


def _empty(factor_buckets) -> Tuple[Ranges, ...]:
    return tuple(() for _ in factor_buckets)


def uniform_work(do_stats: bool, do_light: bool, do_heavy: bool,
                 factor_buckets) -> StepWork:
    """Heavy fires for every bucket in full, or for none."""
    heavy = tuple((((0, b.total),) if do_heavy else ())
                  for b in factor_buckets)
    return StepWork(stats=bool(do_stats), light=bool(do_light), heavy=heavy,
                    launch=_empty(factor_buckets),
                    land=_empty(factor_buckets))


@dataclasses.dataclass(frozen=True)
class Unit:
    """Entry-aligned slot range [lo, hi) of factor bucket ``bucket``,
    firing at steps ``k ≡ phase (mod T)``."""
    bucket: int
    lo: int
    hi: int
    phase: int
    sync_only: bool = False


def _chunk_boundaries(bucket, align: int) -> Tuple[int, ...]:
    bounds = {0, bucket.total}
    for e in bucket.entries:
        if e.offset % align == 0:
            bounds.add(e.offset)
    return tuple(sorted(bounds))


def _split_ranges(bucket, splits: int, align: int
                  ) -> Tuple[Tuple[int, int], ...]:
    """Split a bucket into ≤ ``splits`` chunks at admissible boundaries,
    as evenly as slot counts allow."""
    bounds = _chunk_boundaries(bucket, align)
    n = min(max(1, splits), len(bounds) - 1)
    chosen = [0]
    interior = list(bounds[1:-1])
    for i in range(1, n):
        target = round(i * bucket.total / n)
        if not interior:
            break
        best = min(interior, key=lambda b: abs(b - target))
        if best > chosen[-1]:
            chosen.append(best)
            interior = [b for b in interior if b > best]
    chosen.append(bucket.total)
    return tuple((lo, hi) for lo, hi in zip(chosen, chosen[1:]) if hi > lo)


class Scheduler:
    """Maps a step index to a :class:`StepWork` mask (see module doc)."""

    def __init__(self, cfg, factor_buckets, *, splits: Optional[int] = None,
                 align: int = 1, stagger: Optional[bool] = None,
                 warmup: bool = True):
        self.cfg = cfg
        self.buckets = tuple(factor_buckets)
        self.stagger = cfg.stagger if stagger is None else stagger
        self.warmup = warmup
        variant = cfg.policy.variant
        self.has_light = policy_lib.has_light(variant)
        period_field = policy_lib.heavy_period_field(variant)
        self.T_heavy = (None if period_field is None
                        else int(getattr(cfg, period_field)))
        splits = cfg.stagger_splits if splits is None else splits
        self.units: Tuple[Unit, ...] = self._assign_phases(splits, align)

    def _assign_phases(self, splits: int, align: int) -> Tuple[Unit, ...]:
        from repro_torch.core import kfactor
        T = self.T_heavy
        if T is None:
            # pure-Brand variant: the dense buckets the policy demoted get
            # one warmup-only unit each, or their spectrum stays empty
            return tuple(Unit(bucket=bi, lo=0, hi=b.total, phase=0,
                              sync_only=True)
                         for bi, b in enumerate(self.buckets)
                         if kfactor.has_heavy_op(b.spec))
        chunks = []
        for bi, b in enumerate(self.buckets):
            if not kfactor.has_heavy_op(b.spec):
                continue
            snap = 1
            if self.has_light and b.spec.mode in kfactor._HAS_BRAND:
                snap = self.cfg.T_brand if T % self.cfg.T_brand == 0 else 0
            for lo, hi in _split_ranges(b, splits if self.stagger else 1,
                                        align):
                chunks.append((bi, lo, hi, snap))
        n_units = len(chunks)
        units = []
        for i, (bi, lo, hi, snap) in enumerate(chunks):
            if not self.stagger or snap == 0:
                phase = 0
            else:
                raw = (i * T) // max(n_units, 1)
                phase = (raw // snap) * snap % T
            units.append(Unit(bucket=bi, lo=lo, hi=hi, phase=phase))
        return tuple(units)

    @property
    def cycle(self) -> int:
        """Length of the full schedule cycle (distinct-mask period)."""
        c = self.cfg.T_updt
        if self.has_light:
            c = math.lcm(c, self.cfg.T_brand)
        if self.T_heavy is not None:
            c = math.lcm(c, self.T_heavy)
        return c

    def work(self, step: int) -> StepWork:
        stats = step % self.cfg.T_updt == 0
        light = self.has_light and step % self.cfg.T_brand == 0
        heavy = [[] for _ in self.buckets]
        if self.T_heavy is None:
            if self.warmup and step == 0:
                for u in self.units:
                    heavy[u.bucket].append((u.lo, u.hi))
        else:
            for u in self.units:
                if step % self.T_heavy == u.phase or (self.warmup
                                                      and step == 0):
                    heavy[u.bucket].append((u.lo, u.hi))
        return StepWork(stats=stats, light=light,
                        heavy=tuple(_merge(r) for r in heavy),
                        launch=_empty(self.buckets),
                        land=_empty(self.buckets))


def _merge(ranges: Sequence[Tuple[int, int]]) -> Ranges:
    """Sort and merge adjacent/overlapping ranges."""
    out: list = []
    for lo, hi in sorted(ranges):
        if out and lo <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], hi))
        else:
            out.append((lo, hi))
    return tuple(out)
