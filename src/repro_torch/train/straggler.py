"""Straggler detection and mitigation.

Counterpart of ``src/repro/train/straggler.py`` (plain Python, kept as a
copy).

At pod scale, synchronous SPMD steps run at the speed of the slowest chip;
persistent stragglers (thermal throttling, flaky HICs) must be detected and
acted on.  Detection is *relative to peers*: each step every host reports
its local step wall-time; a host whose time exceeds ``ratio ×`` the fleet
median for ``patience`` consecutive steps is flagged (a fleet-wide slowdown
moves the median itself and flags nobody — that is a capacity problem, not
a straggler).

Mitigations (policy enum, enacted by the launcher):
  * REBALANCE  — checkpoint + elastic remesh without the slow host
    (train/elastic.py ladder) after ``rebalance_after`` slow steps;
  * DROP_STATS — skip the K-FAC heavy update on the next scheduled step.
    The paper's stale-inverse tolerance makes this safe: Prop 4.1/4.2 show
    B-updates strictly beat no-updates in the worst case, so *deferring*
    curvature work under time pressure degrades gracefully;
  * NONE — log only.
"""
from __future__ import annotations

import dataclasses
import enum
import statistics
from typing import Dict, List


class Action(enum.Enum):
    NONE = "none"
    DROP_STATS = "drop_stats"
    REBALANCE = "rebalance"


@dataclasses.dataclass
class StragglerDetector:
    """``writer`` (a :class:`repro_torch.obs.TelemetryWriter`) mirrors every
    enacted Action into the resilience layer's remediation event stream
    (stage 4 — elastic/topology actions, same rung as ElasticRunner's
    repartitions), so ``repro_torch.obs.summary`` counts straggler
    mitigations next to health-guard remediations."""
    ratio: float = 1.5           # slow if dt > ratio × fleet median
    patience: int = 3            # consecutive slow steps → DROP_STATS
    rebalance_after: int = 8     # consecutive slow steps → REBALANCE
    warmup: int = 3              # steps before any flagging
    writer: object = None
    mesh_desc: str = ""          # e.g. "data=4×curv=2": a REBALANCE on a
                                 # 2D mesh repartitions both axes' slot /
                                 # row ranges, so the remediation event
                                 # names the topology being rebuilt

    def __post_init__(self):
        self._streaks: Dict[str, int] = {}
        self._n = 0
        self._median_ema: float = 0.0
        self.events: List[dict] = []

    def _record(self, step: int, host: str, action: str, dt: float,
                med: float) -> None:
        self.events.append({"step": step, "host": host,
                            "action": action, "dt": dt})
        if self.writer is not None:
            mesh = f" on mesh {self.mesh_desc}" if self.mesh_desc else ""
            self.writer.emit(
                "remediation", step=int(step), stage=4, action=action,
                detail=f"straggler {host}: {dt * 1e3:.0f}ms vs fleet "
                       f"median {med * 1e3:.0f}ms{mesh}")

    def observe_step(self, step: int, times: Dict[str, float]
                     ) -> Dict[str, Action]:
        """Feed one synchronous step's per-host wall-times."""
        self._n += 1
        med = statistics.median(times.values())
        self._median_ema = (0.9 * self._median_ema + 0.1 * med
                            if self._median_ema else med)
        out: Dict[str, Action] = {}
        for host, dt in times.items():
            slow = self._n > self.warmup and dt > self.ratio * med
            streak = self._streaks.get(host, 0) + 1 if slow else 0
            self._streaks[host] = streak
            if streak >= self.rebalance_after:
                self._record(step, host, "rebalance", dt, med)
                self._streaks[host] = 0
                out[host] = Action.REBALANCE
            elif streak >= self.patience:
                self._record(step, host, "drop_stats", dt, med)
                out[host] = Action.DROP_STATS
            else:
                out[host] = Action.NONE
        return out

    @property
    def fleet_median(self) -> float:
        return self._median_ema


def apply_to_flags(action: Action, flags: Dict[str, bool]
                   ) -> Dict[str, bool]:
    """DROP_STATS: defer the K-FAC stats/inverse work this step (safe by
    Prop 4.1/4.2 — see module docstring)."""
    if action == Action.DROP_STATS:
        return dict(flags, do_stats=False, do_light=False, do_heavy=False)
    return flags


def apply_to_work(action: Action, work):
    """StepWork-mask counterpart of :func:`apply_to_flags` for the
    scheduled (staggered / sharded) step path."""
    if action == Action.DROP_STATS:
        return dataclasses.replace(
            work, stats=False, light=False,
            heavy=tuple(() for _ in work.heavy),
            launch=tuple(() for _ in work.launch),
            land=tuple(() for _ in work.land))
    return work
