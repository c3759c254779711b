"""Tracing hooks: name the hot path for ``torch.profiler``.

Counterpart of ``src/repro/obs/trace.py``.  Two kinds of annotation:

  * :func:`span` — a ``torch.profiler.record_function`` range around
    optimizer work (the bucketed factor and precondition calls, the
    per-bucket stats / Brand / heavy / launch / land phases).  Spans
    nest by name, as the reference's ``jax.named_scope`` does: a span
    opened inside ``kfac/factor/b3_brand`` is recorded as
    ``kfac/factor/b3_brand/light_brand``.  Once CUDA is initialised each
    span also pushes an NVTX range of the same name.
  * :func:`host_span` — the same for host work outside the optimizer's
    call tree (the async runner's worker thread); its name is not joined
    to an enclosing span.

Without an active profiler a span costs a few microseconds of host time
and launches nothing.

:class:`StepProfiler` captures steps [first, first + steps): each step is
one window, its own ``torch.profiler.profile`` over the CPU and (on a
card) CUDA activities, exported as ``<log_dir>/step_<k>.json`` (a Chrome
trace) and kept in ``windows[k]`` for ``key_averages()`` / ``events()``.
"""
from __future__ import annotations

import contextlib
import os
import threading
from typing import Dict, List, Optional

import torch

_TLS = threading.local()


def _stack() -> List[str]:
    st = getattr(_TLS, "stack", None)
    if st is None:
        st = _TLS.stack = []
    return st


@contextlib.contextmanager
def _range(name: str):
    nvtx = torch.cuda.is_initialized()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


@contextlib.contextmanager
def span(name: str):
    """Label optimizer work; nested spans join their names with "/"."""
    st = _stack()
    st.append(name)
    try:
        with _range("/".join(st)):
            yield
    finally:
        st.pop()


@contextlib.contextmanager
def host_span(name: str):
    """Label host-side work (its name as given)."""
    with _range(name):
        yield


class StepProfiler:
    """Profile steps [first, first + steps), one window per step.

    ``tick(k)`` is called just before step ``k`` runs (from the loop, or
    from a callback after step ``k − 1``): it closes the window of the
    previous step and opens step ``k``'s while ``k`` is in range;
    ``close()`` stops a still-open window (early exit).  An inactive
    instance (``log_dir=None``) does nothing, so the loop can tick it
    every step."""

    def __init__(self, log_dir: Optional[str], first: int = 1,
                 steps: int = 3):
        self.log_dir = log_dir or None
        self.first = int(first)
        self.last = int(first) + int(steps)     # exclusive
        self.windows: Dict[int, torch.profiler.profile] = {}
        self._prof: Optional[torch.profiler.profile] = None
        self._step: Optional[int] = None

    def _stop(self) -> None:
        if self._prof is None:
            return
        prof, k = self._prof, self._step
        self._prof = self._step = None
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        prof.stop()
        os.makedirs(self.log_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(self.log_dir,
                                              f"step_{k}.json"))
        self.windows[k] = prof

    def tick(self, k: int) -> None:
        if self.log_dir is None:
            return
        self._stop()
        if self.first <= k < self.last:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_initialized():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
                torch.cuda.synchronize()
            self._prof = torch.profiler.profile(activities=acts)
            self._prof.start()
            self._step = int(k)

    def close(self) -> None:
        self._stop()
