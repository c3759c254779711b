"""Typed configuration specs for the training entry points.

Counterpart of ``src/repro/specs.py`` (the same four frozen dataclasses,
the same legacy-kwarg table, the same warnings and errors):

  * :class:`DistSpec`        mesh / curvature_axis / row_axis /
                             curvature_compress
  * :class:`ObsSpec`         writer / metrics_every / profile knobs
  * :class:`CkptSpec`        ckpt dir / cadence / retention
  * :class:`ResilienceSpec`  health guards / remediation policy / chaos

The old flat kwargs keep working through
:func:`consolidate_training_kwargs`: each legacy name warns **once per
process** and is folded into the equivalent spec.  Passing a spec AND one
of the legacy kwargs it subsumes is an error (two sources of truth).

An active :class:`DistSpec` builds the distributed curvature engine
(``distributed/curvature.py``) lazily in :meth:`DistSpec.attach`.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Dict, Optional, Set, Tuple

_WARNED: Set[str] = set()


def warn_once(key: str, msg: str, stacklevel: int = 3) -> None:
    """Emit a DeprecationWarning once per process per ``key``."""
    if key in _WARNED:
        return
    _WARNED.add(key)
    warnings.warn(msg, DeprecationWarning, stacklevel=stacklevel)


@dataclasses.dataclass(frozen=True)
class DistSpec:
    """Distributed-execution spec: where factor work shards (the
    reference's curvature engine over a mesh axis)."""
    mesh: Any = None
    curvature_axis: Optional[str] = None
    row_axis: Optional[str] = None
    curvature_compress: Optional[int] = None

    @property
    def active(self) -> bool:
        return self.mesh is not None and self.curvature_axis is not None

    def attach(self, opt) -> Optional[Any]:
        """Build + attach the curvature engine for ``opt`` (a Kfac) → the
        engine; a no-op returning None when no mesh/axis is configured."""
        if not self.active:
            return None
        from repro_torch.distributed import curvature as curvature_lib
        return curvature_lib.CurvatureEngine.for_kfac(
            opt, self.mesh, self.curvature_axis, row_axis=self.row_axis,
            compress_rank=self.curvature_compress)


@dataclasses.dataclass(frozen=True)
class ObsSpec:
    """Observability spec: the run's telemetry writer plus the metrics
    cadence (``metrics_every`` steps per flush window; 0 = off) and
    optional profiler-trace knobs."""
    writer: Any = None                  # repro_torch.obs.TelemetryWriter
    metrics_every: int = 0
    profile_dir: Optional[str] = None
    profile_steps: int = 3

    def make_meter(self, opt) -> Optional[Any]:
        """A curvature :class:`~repro_torch.obs.metrics.Meter` on
        ``opt``'s device flushing to ``writer`` every ``metrics_every``
        steps, or None when metrics are off."""
        if self.metrics_every <= 0 or self.writer is None:
            return None
        from repro_torch.obs import metrics as obs_metrics
        catalog = obs_metrics.catalog_for(opt)
        kinds = {s.name: s.kind for s in catalog}
        return obs_metrics.Meter(catalog, self.writer.metrics_sink(kinds),
                                 every=self.metrics_every,
                                 device=opt.device)


@dataclasses.dataclass(frozen=True)
class CkptSpec:
    """Checkpointing spec: snapshot directory, save cadence (healthy
    steps between saves), and ring retention."""
    dir: Optional[str] = None
    every: int = 5
    keep: int = 3

    @property
    def active(self) -> bool:
        return self.dir is not None


@dataclasses.dataclass(frozen=True)
class ResilienceSpec:
    """Resilience spec: ``health`` (truthy, or a
    ``repro_torch.train.health.HealthConfig``) arms the guards + staged
    remediation ladder; a caller-built ``RemediationPolicy`` can ride as
    ``policy``; ``chaos`` (a ``ChaosMonkey``) injects its fault plan into
    the loop's hooks."""
    health: Any = None
    policy: Any = None
    chaos: Any = None

    @property
    def active(self) -> bool:
        return bool(self.health) or self.policy is not None


#: legacy run_kfac_training kwarg → (spec slot, spec field)
_LEGACY_TRAINING_KWARGS: Dict[str, Tuple[str, str]] = {
    "mesh": ("dist", "mesh"),
    "curvature_axis": ("dist", "curvature_axis"),
    "row_axis": ("dist", "row_axis"),
    "curvature_compress": ("dist", "curvature_compress"),
    "writer": ("obs", "writer"),
    "metrics_every": ("obs", "metrics_every"),
    "health": ("resilience", "health"),
    "policy": ("resilience", "policy"),
    "chaos": ("resilience", "chaos"),
    "ckpt_dir": ("ckpt", "dir"),
    "ckpt_every": ("ckpt", "every"),
    "ckpt_keep": ("ckpt", "keep"),
}

_SPEC_TYPES = {"dist": DistSpec, "obs": ObsSpec, "ckpt": CkptSpec,
               "resilience": ResilienceSpec}


def consolidate_training_kwargs(
        legacy: Dict[str, Any], *, dist: Optional[DistSpec] = None,
        obs: Optional[ObsSpec] = None, ckpt: Optional[CkptSpec] = None,
        resilience: Optional[ResilienceSpec] = None, caller: str = "",
        ) -> Tuple[DistSpec, ObsSpec, CkptSpec, ResilienceSpec]:
    """Fold legacy flat kwargs into the four specs (deprecation shim).

    Unknown kwargs raise TypeError; a legacy kwarg whose subsuming spec
    was also passed raises ValueError; every accepted legacy kwarg warns
    once per process, naming its replacement."""
    given = {"dist": dist, "obs": obs, "ckpt": ckpt,
             "resilience": resilience}
    overrides: Dict[str, Dict[str, Any]] = {}
    for name, value in legacy.items():
        if name not in _LEGACY_TRAINING_KWARGS:
            raise TypeError(f"{caller or 'run_kfac_training'}() got an "
                            f"unexpected keyword argument {name!r}")
        slot, field = _LEGACY_TRAINING_KWARGS[name]
        if given[slot] is not None:
            raise ValueError(
                f"{caller or 'run_kfac_training'}(): legacy kwarg "
                f"{name!r} conflicts with the {slot}= spec that was also "
                f"passed — set {_SPEC_TYPES[slot].__name__}.{field} "
                f"instead")
        warn_once(f"training-kwarg:{name}",
                  f"{caller or 'run_kfac_training'}({name}=...) is "
                  f"deprecated; pass {slot}="
                  f"{_SPEC_TYPES[slot].__name__}({field}=...) "
                  f"(repro_torch.specs)", stacklevel=4)
        overrides.setdefault(slot, {})[field] = value
    out = {}
    for slot, spec_type in _SPEC_TYPES.items():
        spec = given[slot]
        if spec is None:
            spec = spec_type(**overrides.get(slot, {}))
        out[slot] = spec
    return out["dist"], out["obs"], out["ckpt"], out["resilience"]
