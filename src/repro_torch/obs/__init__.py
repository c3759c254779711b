"""Telemetry for the K-FAC hot path: device-resident metrics, structured
JSONL events, and profiler tracing hooks.

Counterpart of ``src/repro/obs/__init__.py`` (the same re-exports).  Three
layers, strictly observational (numerically inert — asserted in
tests/test_torch_obs.py):

  * :mod:`repro_torch.obs.metrics` — a :class:`~repro_torch.obs.metrics.Meter`
    over a closed per-optimizer metric catalog; the hot path calls
    ``metrics.record(name, value)``, a no-op outside an active collector.
    The buffer stays on the device and reaches the host in one transfer
    every ``every`` steps.
  * :mod:`repro_torch.obs.events` — :class:`~repro_torch.obs.events.TelemetryWriter`,
    schema-versioned JSONL events (the reference's format) with a
    human-readable console sink.
  * :mod:`repro_torch.obs.trace` — ``torch.profiler`` ranges (and NVTX on
    the card) around the bucketed factor/precondition calls and the async
    runner's worker thread, plus a per-step profile capturer.

``python -m repro_torch.obs.summary run/telemetry.jsonl`` renders a run's
event log into a per-phase timing + curvature-health report.
"""
from repro_torch.obs.events import (SCHEMA_VERSION,  # noqa: F401
                                    TelemetryWriter, read_events,
                                    validate_event)
from repro_torch.obs.metrics import Meter, active, record  # noqa: F401
from repro_torch.obs.trace import StepProfiler, host_span, span  # noqa: F401
