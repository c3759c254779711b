"""Curvature metrics for the K-FAC hot path, kept on the device.

Counterpart of ``src/repro/obs/metrics.py``: the same closed catalog per
optimizer (:func:`catalog_for` — names, kinds and order), the same
thread-local collector stack and ``record`` API, the same
counter/gauge semantics.  Design constraints, in order:

  1. **Numerically inert.**  A metric is computed *from* hot-path
     tensors and never fed back; ``record`` is a no-op without an active
     collector, and a thunk passed as the value is only evaluated under
     one, so a metrics-off step runs no extra kernel.
  2. **No per-step host sync.**  The buffer (:meth:`Meter.init`) is a
     dict of 0-d fp32 tensors on the device — views of one flat tensor —
     plus the window's step count on the host.  A step's collector is
     folded in with in-place device ops (a counter adds, a gauge is
     overwritten); every ``every`` steps :meth:`Meter.maybe_flush` moves
     the whole buffer to the host in **one** transfer, hands it to the
     sink and zeroes the counters.
  3. **Static structure.**  Every step variant's buffer has the same
     keys: the catalog is closed per optimizer.

Two accumulation kinds:

  * ``counter`` — summed across the flush window, reset to 0 at flush;
  * ``gauge``   — last written value wins, persists across flushes.
"""
from __future__ import annotations

import contextlib
import itertools
import threading
from typing import Any, Callable, Dict, List, NamedTuple, Tuple, Union

import torch

from repro_torch import device as device_lib

COUNTER = "counter"
GAUGE = "gauge"

#: modes whose heavy overwrite truncates a spectrum (AUX_TRUNC channel)
_TRUNC_MODES = ("evd", "rsvd", "brand_rsvd")


class MetricSpec(NamedTuple):
    """One named scalar in the closed catalog."""
    name: str
    kind: str
    doc: str = ""


def catalog_for(opt) -> Tuple[MetricSpec, ...]:
    """The closed metric catalog for one ``Kfac`` optimizer (duck-typed:
    only ``factor_buckets`` / ``_async_buckets`` are read).  Per-bucket
    entries exist only where the bucket's mode can produce them."""
    specs: List[MetricSpec] = [
        MetricSpec("work/stats_fired", COUNTER,
                   "steps that absorbed a stats batch"),
        MetricSpec("work/light_fired", COUNTER,
                   "steps that ran the Brand light update"),
        MetricSpec("work/heavy_slots", COUNTER,
                   "factor slots whose heavy op fired inline"),
        MetricSpec("work/launch_slots", COUNTER,
                   "factor slots snapshotted into the async pipeline"),
        MetricSpec("work/land_slots", COUNTER,
                   "factor slots whose async heavy result landed"),
        MetricSpec("precond/damping_phi", GAUGE,
                   "damping ratio φ_λ at the last step"),
        # resilience layer (train/health.py) — all zero on healthy runs
        MetricSpec("health/guard_trips", COUNTER,
                   "steps the guard skipped (update not applied)"),
        MetricSpec("health/grad_nonfinite", COUNTER,
                   "nonfinite gradient entries seen by the guard"),
        MetricSpec("health/update_nonfinite", COUNTER,
                   "nonfinite preconditioned-update entries seen"),
    ]
    for bi, bucket in enumerate(opt.factor_buckets):
        mode = bucket.spec.mode.value
        p = f"bucket{bi}"
        specs.append(MetricSpec(f"{p}/heavy_slots", COUNTER,
                                f"[{mode}] slots refreshed (inline+landed)"))
        specs.append(MetricSpec(f"health/{p}/factor_nonfinite", COUNTER,
                                "nonfinite factor-state entries seen by "
                                "the guard"))
        if mode == "ns":
            specs.append(MetricSpec(f"{p}/ns_lam", GAUGE,
                                    "mean λ̂ of the last NS refresh"))
            specs.append(MetricSpec(f"{p}/ns_res", GAUGE,
                                    "worst-slot NS Frobenius residual "
                                    "(≥0.5 ⇒ dense fallback fired)"))
        if mode in _TRUNC_MODES:
            specs.append(MetricSpec(f"{p}/trunc_mass", GAUGE,
                                    "worst-slot truncated spectral-mass "
                                    "fraction of the last overwrite"))
        if bucket.spec.needs_m:
            specs.append(MetricSpec(f"{p}/inv_err", GAUGE,
                                    "row-sampled ‖(M+λI)X−I‖_F/√k of the "
                                    "freshly refreshed slots"))
        if bi in getattr(opt, "_async_buckets", {}):
            specs.append(MetricSpec(f"{p}/replay_depth", GAUGE,
                                    "interim Brand panels replayed per "
                                    "landing (static)"))
    return tuple(specs)


# ---------------------------------------------------------------------------
# thread-local collector stack — record() is the hot path's only API
# ---------------------------------------------------------------------------

_TLS = threading.local()


def _stack() -> List["Collector"]:
    st = getattr(_TLS, "stack", None)
    if st is None:
        st = _TLS.stack = []
    return st


def active() -> bool:
    """True iff a collector is listening on this thread — guard for
    metrics whose *computation* should stay off un-instrumented steps."""
    return bool(_stack())


def record(name: str, value: Union[Any, Callable[[], Any]]) -> None:
    """Record one named scalar into the innermost active collector.
    No-op (and ``value`` untouched, if callable) when none is active;
    names outside the collector's catalog are ignored."""
    st = _stack()
    if st:
        st[-1].record(name, value)


class Collector:
    """One step's recorded values, keyed by catalog name: 0-d fp32
    tensors for values computed on the device, Python floats for values
    the host already knows."""

    def __init__(self, catalog: Tuple[MetricSpec, ...]):
        self.kinds: Dict[str, str] = {s.name: s.kind for s in catalog}
        self.values: Dict[str, Any] = {}

    def record(self, name: str, value) -> None:
        kind = self.kinds.get(name)
        if kind is None:
            return
        if callable(value):
            value = value()
        v = (value.detach().to(torch.float32).reshape(())
             if isinstance(value, torch.Tensor) else float(value))
        if kind == COUNTER and name in self.values:
            self.values[name] = self.values[name] + v
        else:
            self.values[name] = v


# ---------------------------------------------------------------------------
# host-side sink registry
# ---------------------------------------------------------------------------

_SINKS: Dict[int, Callable] = {}
_SINK_IDS = itertools.count()


def register_sink(fn: Callable[[int, int, Dict[str, float]], None]) -> int:
    """Register ``fn(step, window_steps, values)`` and return its id."""
    sid = next(_SINK_IDS)
    _SINKS[sid] = fn
    return sid


class Meter:
    """Ties a metric catalog to a flush cadence, a sink and a device.

    The mutable state is the buffer returned by :meth:`init`: the
    catalog's 0-d fp32 tensors (views of ``buf["_flat"]``, on
    ``device``) and the window's step count ``buf["_steps"]`` (a host
    int).  ``device=None`` means the card."""

    def __init__(self, catalog: Tuple[MetricSpec, ...], sink: Callable,
                 every: int = 10, device=None):
        if every <= 0:
            raise ValueError(f"flush cadence must be positive, got {every}")
        self.catalog = catalog
        self.every = int(every)
        self.device = device_lib.resolve(device)
        self.sink_id = register_sink(sink)
        self._names = tuple(s.name for s in catalog)
        self._kinds = {s.name: s.kind for s in catalog}
        self._counter_mask = torch.tensor(
            [self._kinds[n] == COUNTER for n in self._names],
            dtype=torch.bool, device=self.device)

    @classmethod
    def for_opt(cls, opt, sink: Callable, every: int = 10) -> "Meter":
        return cls(catalog_for(opt), sink, every=every, device=opt.device)

    # -- buffer lifecycle ---------------------------------------------------
    def init(self) -> Dict[str, Any]:
        flat = torch.zeros(len(self._names), dtype=torch.float32,
                           device=self.device)
        buf: Dict[str, Any] = {n: flat[i] for i, n in enumerate(self._names)}
        buf["_flat"] = flat
        buf["_steps"] = 0
        return buf

    def collecting(self):
        """Context manager entered around the optimizer call; yields the
        :class:`Collector`."""
        return _collecting(self.catalog)

    def merge(self, buf: Dict[str, Any], col: Collector) -> Dict[str, Any]:
        """Fold one step's collector into the buffer (in place, on the
        device: one small kernel a recorded name) and return it."""
        buf["_steps"] += 1
        for name, v in col.values.items():
            t = buf[name]
            if self._kinds[name] == COUNTER:
                t.add_(v)
            elif isinstance(v, torch.Tensor):
                t.copy_(v)
            else:
                t.fill_(v)
        return buf

    # -- flushing -----------------------------------------------------------
    def _emit(self, buf: Dict[str, Any], step: int) -> None:
        vals = buf["_flat"].cpu().tolist()          # the one transfer
        sink = _SINKS.get(self.sink_id)
        if sink is not None:
            sink(int(step), int(buf["_steps"]),
                 dict(zip(self._names, vals)))

    def maybe_flush(self, buf: Dict[str, Any], step: int
                    ) -> Dict[str, Any]:
        """Emit the buffer through the sink and reset the window — only
        when the window is full.  ``step`` is the optimizer step stamped
        onto the flush."""
        if buf["_steps"] >= self.every:
            self._emit(buf, step)
            buf["_steps"] = 0
            buf["_flat"].masked_fill_(self._counter_mask, 0.0)
        return buf

    def drain(self, buf: Dict[str, Any], step: int) -> None:
        """Final flush of a partial window (end of run)."""
        if buf["_steps"] == 0:
            return
        self._emit(buf, step)

    def kinds(self) -> Dict[str, str]:
        return dict(self._kinds)


@contextlib.contextmanager
def _collecting(catalog):
    col = Collector(catalog)
    _stack().append(col)
    try:
        yield col
    finally:
        _stack().pop()
