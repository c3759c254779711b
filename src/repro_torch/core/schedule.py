"""The K-FAC work scheduler: static per-step work masks, with optional
*staggering* of the heavy inverse recomputations.

Counterpart of ``src/repro/core/schedule.py`` (a copy: the port imports
nothing of the reference).  ``stats``/``light`` are global per step; heavy
work is per factor bucket as slot ranges.  The :class:`Scheduler` gives
each unit (a bucket, or an entry-aligned chunk of one) a phase spread over
the heavy period, snapped to multiples of ``T_brand`` for Brand-family
buckets (pinned to 0 when ``T_brand`` does not divide the period), fires
every unit at step 0 (warmup), and gives the dense buckets of a pure-Brand
variant a warmup-only unit.

Async launch/land (``cfg.async_heavy``), as in the reference: with
``heavy_lag = L`` each regular heavy firing of an async unit becomes a
*launch* (the factor state is snapshotted into the in-flight buffer) and,
``L`` steps later, a *land* (the heavy result computed from the snapshot,
interim Brand panels replayed on top, is swapped into the live state).
``L = 0`` launches and lands on the same step, which is bit for bit the
synchronous path.  ``L < T`` keeps one snapshot per unit; a Brand-family
bucket pipelines only when ``T_brand`` divides the heavy period, so the
number of panels to replay is the constant ``L // T_brand``; other such
buckets stay ``sync_only`` (inline at phase 0).  The step-0 warmup stays
inline: an empty factor has no spectrum to damp.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

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

    def entry_heavy(self, bucket_idx: int, offset: int, count: int) -> bool:
        """True iff any firing range overlaps slot range [offset,
        offset+count) — the per-tap path's heavy flag for one bucket
        entry (scheduler chunks are entry-aligned: all or nothing)."""
        return any(lo < offset + count and hi > offset
                   for lo, hi in self.heavy[bucket_idx])


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


def remedial_work(cfg, factor_buckets) -> StepWork:
    """An out-of-cadence *forced heavy refresh* — the remediation
    ladder's stage-2 mask (train/health.py): every bucket with a heavy op
    overwrites its full slot range inline, with a stats absorb (and, for
    Brand-family variants, a light absorb) like the step-0 warmup, so the
    inverse rep is re-established from the live M this step.  Launch and
    land stay empty: the caller abandons the in-flight pipeline
    (``Kfac.clear_inflight``, the runner's ``drop_pending``).  For
    pure-Brand buckets the refresh is the stats + light re-absorb
    (reference ``core/schedule.py:171``)."""
    from repro_torch.core import kfactor
    heavy = tuple((((0, b.total),) if kfactor.has_heavy_op(b.spec) else ())
                  for b in factor_buckets)
    return StepWork(stats=True,
                    light=policy_lib.has_light(cfg.policy.variant),
                    heavy=heavy,
                    launch=_empty(factor_buckets),
                    land=_empty(factor_buckets))


def legacy_flags(cfg, step: int) -> Dict[str, bool]:
    """The legacy three-bool view of a step (``KfacConfig.flags``),
    driven by the variant table of ``core/policy.py``: one heavy period
    per variant (reference ``core/schedule.py:198``)."""
    variant = cfg.policy.variant
    period_field = policy_lib.heavy_period_field(variant)
    do_light = (policy_lib.has_light(variant)
                and step % cfg.T_brand == 0)
    do_heavy = (period_field is not None
                and step % getattr(cfg, period_field) == 0)
    return dict(do_stats=step % cfg.T_updt == 0, do_light=do_light,
                do_heavy=do_heavy)


@dataclasses.dataclass(frozen=True)
class Unit:
    """Entry-aligned slot range [lo, hi) of factor bucket ``bucket``,
    firing at steps ``k ≡ phase (mod T)``; ``sync_only`` units fire
    inline even under an async schedule."""
    bucket: int
    lo: int
    hi: int
    phase: int
    sync_only: bool = False


def bucket_is_async(cfg, spec) -> bool:
    """True iff a factor bucket with this spec pipelines its heavy work
    under ``cfg.async_heavy`` (reference ``core/schedule.py:227``).
    Brand-family buckets pipeline only when ``T_brand`` divides the
    variant's heavy period."""
    from repro_torch.core import kfactor
    if not cfg.async_heavy or not kfactor.has_heavy_op(spec):
        return False
    period_field = policy_lib.heavy_period_field(cfg.policy.variant)
    if period_field is None:
        return False
    T = int(getattr(cfg, period_field))
    if (policy_lib.has_light(cfg.policy.variant)
            and spec.mode in kfactor._HAS_BRAND):
        return T % cfg.T_brand == 0
    return True


def n_replay_panels(cfg, spec) -> int:
    """Interim Brand panels replayed at a landing: the light steps in
    (launch, launch + lag], exactly ``lag // T_brand`` because launch
    phases are snapped to multiples of ``T_brand`` (reference
    ``core/schedule.py:246``)."""
    from repro_torch.core import kfactor
    if not bucket_is_async(cfg, spec) or spec.mode not in kfactor._HAS_BRAND:
        return 0
    return int(cfg.heavy_lag) // cfg.T_brand


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
        self.async_heavy = cfg.async_heavy and self.T_heavy is not None
        self.lag = int(cfg.heavy_lag)
        if self.async_heavy and not 0 <= self.lag < self.T_heavy:
            raise ValueError(
                f"heavy_lag={self.lag} must satisfy 0 <= lag < "
                f"T_heavy={self.T_heavy} (one in-flight snapshot per unit)")
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
            sync_only = (self.async_heavy and
                         not bucket_is_async(self.cfg,
                                             self.buckets[bi].spec))
            units.append(Unit(bucket=bi, lo=lo, hi=hi, phase=phase,
                              sync_only=sync_only))
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
        launch = [[] for _ in self.buckets]
        land = [[] for _ in self.buckets]
        warm = self.warmup and step == 0
        if self.T_heavy is None:
            if warm:
                for u in self.units:
                    heavy[u.bucket].append((u.lo, u.hi))
        else:
            T, L = self.T_heavy, self.lag
            for u in self.units:
                fires = step % T == u.phase
                if not self.async_heavy or u.sync_only:
                    if fires or warm:
                        heavy[u.bucket].append((u.lo, u.hi))
                    continue
                # async: the warmup stays inline; regular firings launch
                # and land L steps later
                if warm:
                    heavy[u.bucket].append((u.lo, u.hi))
                if fires and step > 0:
                    launch[u.bucket].append((u.lo, u.hi))
                if step - L > 0 and (step - L) % T == u.phase:
                    land[u.bucket].append((u.lo, u.hi))
        return StepWork(stats=stats, light=light,
                        heavy=tuple(_merge(r) for r in heavy),
                        launch=tuple(_merge(r) for r in launch),
                        land=tuple(_merge(r) for r in land))

    def flags(self, step: int) -> Dict[str, bool]:
        """Legacy three-bool view of this schedule (un-staggered)."""
        return legacy_flags(self.cfg, step)

    def describe(self) -> str:
        """One line: the heavy period, the flags, then each unit as
        ``[b{bucket} {lo}:{hi} @{phase}]`` (the reference's)."""
        parts = [f"T_heavy={self.T_heavy} stagger={self.stagger} "
                 f"async={self.async_heavy} lag={self.lag} "
                 f"units={len(self.units)}"]
        for u in self.units:
            sync = " sync" if u.sync_only else ""
            parts.append(f"[b{u.bucket} {u.lo}:{u.hi} @{u.phase}{sync}]")
        return " ".join(parts)


def _merge(ranges: Sequence[Tuple[int, int]]) -> Ranges:
    """Sort and merge adjacent/overlapping ranges."""
    out: list = []
    for lo, hi in sorted(ranges):
        if out and lo <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], hi))
        else:
            out.append((lo, hi))
    return tuple(out)


def group_by_work(sched: Scheduler, steps: Sequence[int]
                  ) -> Dict[StepWork, Tuple[int, ...]]:
    """Group schedule positions by their StepWork mask: ``steps[i]`` is
    member i's step counter; the result maps each distinct mask to the
    indices that would run it (reference ``core/schedule.py:463``)."""
    groups: Dict[StepWork, list] = {}
    for i, k in enumerate(steps):
        groups.setdefault(sched.work(int(k)), []).append(i)
    return {w: tuple(ix) for w, ix in groups.items()}
