"""Structured event log: schema-versioned JSONL + human-readable console.

Counterpart of ``src/repro/obs/events.py`` (plain Python, kept as a
copy): the same envelope, ``SCHEMA_VERSION``, event types, required
fields and console lines, so one log format serves both packages — a log
written here passes the reference's ``repro.obs.summary --validate`` and
this package's ``python -m repro_torch.obs.summary --validate``.

Every event is one JSON object per line with a fixed envelope::

    {"schema": 1, "t": <unix time>, "type": "<event type>", ...fields}

The per-type required fields live in :data:`EVENT_TYPES`; extra fields
are allowed, missing required fields are an :class:`EventSchemaError` at
*write* time, so a malformed emitter fails its own run instead of
poisoning the log.
"""
from __future__ import annotations

import json
import time
from typing import Any, Callable, Dict, Iterator, Optional

#: Event-log schema version — bump when an existing event type changes
#: incompatibly (adding new types or optional fields is compatible).
#:   v1  the initial schema
SCHEMA_VERSION = 1

#: event type → required field names (beyond the envelope)
EVENT_TYPES: Dict[str, frozenset] = {
    # lifecycle
    "run_start": frozenset({"config"}),
    "run_end": frozenset({"steps", "loss_first", "loss_last", "s_per_step"}),
    "log": frozenset({"msg"}),
    # training
    "step": frozenset({"step", "loss", "dt_s", "phase"}),
    "metrics": frozenset({"step", "window_steps", "values", "kinds"}),
    "sched": frozenset({"detail"}),
    # async heavy pipeline
    "async_launch": frozenset({"step", "bucket", "lo", "hi"}),
    "async_land": frozenset({"step", "bucket", "lo", "hi", "overlapped"}),
    "async_miss": frozenset({"step", "bucket", "lo", "hi"}),
    # fault tolerance / elasticity
    "ckpt_save": frozenset({"step", "path"}),
    "ckpt_restore": frozenset({"step", "path"}),
    "repartition": frozenset({"detail"}),
    # resilience layer (train/health.py): one event per enacted ladder
    # action.  ``stage`` is the ladder rung (0 skip, 1 damping, 2 forced
    # refresh, 3 rollback, 4 elastic/repartition), ``action`` the verb.
    # ``async_miss`` events additionally carry an optional ``reason``
    # field (timeout | crash | resume | dropped) — optional, so v1 logs
    # stay valid.
    "remediation": frozenset({"step", "stage", "action", "detail"}),
    # serving.  ``serve_request`` optionally carries ``tenant`` (bank
    # slot) and ``kind`` (infer | finetune) — optional, so v1 logs stay
    # valid; ``tenant_update`` is one completed fine-tune step of one
    # tenant's stacked optimizer state (multi-tenant service).
    "serve_request": frozenset({"uid", "wait_s", "total_s", "n_new"}),
    "tenant_update": frozenset({"tenant", "step", "loss", "phase"}),
}


class EventSchemaError(ValueError):
    """An event violates the JSONL schema (unknown type / missing field)."""


def validate_event(ev: Dict[str, Any]) -> None:
    for field in ("schema", "t", "type"):
        if field not in ev:
            raise EventSchemaError(f"event missing envelope field "
                                   f"{field!r}: {ev!r}")
    etype = ev["type"]
    required = EVENT_TYPES.get(etype)
    if required is None:
        raise EventSchemaError(f"unknown event type {etype!r}")
    missing = required - ev.keys()
    if missing:
        raise EventSchemaError(f"event {etype!r} missing required "
                               f"fields {sorted(missing)}: {ev!r}")


def read_events(path: str, validate: bool = True) -> Iterator[dict]:
    """Parse (and by default validate) a JSONL event log."""
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                ev = json.loads(line)
            except json.JSONDecodeError as e:
                raise EventSchemaError(
                    f"{path}:{lineno}: not valid JSON: {e}") from e
            if validate:
                try:
                    validate_event(ev)
                except EventSchemaError as e:
                    raise EventSchemaError(f"{path}:{lineno}: {e}") from e
            yield ev


def _fmt_console(ev: dict) -> Optional[str]:
    """Human-readable rendering — preserves the trainer's familiar
    ``[train] ...`` lines; returns None for types kept off the console
    (high-rate machine-facing events)."""
    t = ev["type"]
    if t == "log":
        return f"[train] {ev['msg']}"
    if t == "step":
        return (f"[train] step {ev['step']:5d} loss {ev['loss']:8.4f} "
                f"({ev['dt_s'] * 1e3:6.0f}ms {ev['phase']})")
    if t == "run_end":
        return (f"[train] done: loss {ev['loss_first']:.4f} -> "
                f"{ev['loss_last']:.4f} ({ev['s_per_step']:.2f}s/step)")
    if t == "ckpt_save":
        return f"[train] checkpoint saved @ step {ev['step']}"
    if t == "ckpt_restore":
        return f"[train] resumed at step {ev['step']}"
    if t == "sched":
        return f"[train] {ev['detail']}"
    if t == "async_miss":
        reason = ev.get("reason", "resume")
        return (f"[train] async landing miss ({reason}): bucket "
                f"{ev['bucket']} slots [{ev['lo']},{ev['hi']}) @ step "
                f"{ev['step']} (landing in-graph)")
    if t == "remediation":
        return (f"[train] remediation stage {ev['stage']} "
                f"({ev['action']}) @ step {ev['step']}: {ev['detail']}")
    if t == "repartition":
        return f"[train] repartition: {ev['detail']}"
    return None     # metrics / launch / land / serve: JSONL only


class TelemetryWriter:
    """Emit schema-validated events to a JSONL file and/or the console.

    ``path=None`` keeps console-only operation (the default trainer
    experience); ``console=False`` makes it log-file-only (benchmarks,
    tests).  Safe to use as a context manager; ``close()`` is
    idempotent."""

    def __init__(self, path: Optional[str] = None, console: bool = True,
                 console_fn: Callable[[str], None] = None):
        self.path = path
        self._console = console
        self._print = console_fn if console_fn is not None else (
            lambda s: print(s, flush=True))
        self._f = open(path, "a") if path else None

    def emit(self, etype: str, **fields) -> dict:
        ev = {"schema": SCHEMA_VERSION, "t": time.time(), "type": etype,
              **fields}
        validate_event(ev)
        if self._f is not None:
            self._f.write(json.dumps(ev) + "\n")
            self._f.flush()
        if self._console:
            line = _fmt_console(ev)
            if line is not None:
                self._print(line)
        return ev

    def log(self, msg: str) -> None:
        """Free-form console line, structured as a ``log`` event."""
        self.emit("log", msg=msg)

    def metrics_sink(self, kinds: Dict[str, str]) -> Callable:
        """A ``Meter`` flush sink that lands each window as one
        ``metrics`` event (kinds ride along so the summary can sum
        counters and last-value gauges without out-of-band state)."""
        def sink(step: int, window_steps: int,
                 values: Dict[str, float]) -> None:
            self.emit("metrics", step=step, window_steps=window_steps,
                      values=values, kinds=kinds)
        return sink

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None

    def __enter__(self) -> "TelemetryWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
