"""Training loop: ties a tapped model's loss and an optimizer (the K-FAC
family or a baseline) into steps.

Counterpart of ``src/repro/train/loop.py``.  One backward pass
(``torch.autograd.grad`` over parameters and probes together) gives the
parameter gradients and the probe gradients — the backward K-factor
square roots.

:class:`AsyncInverseRunner` is the loop-level half of the async heavy
pipeline (``KfacConfig.async_heavy``): right after a launch step wrote a
snapshot into ``KfacState.inflight``, the runner computes the heavy
overwrite of those slots in a worker thread — on the card on a CUDA side
stream of the lowest priority, where the reference uses a spare device —
and hands the result to the land step ``lag`` steps later, which then
only swaps tensors and replays the interim Brand panels.  Without a
runner the land step computes the same function in line.

The reference's distributed, telemetry, checkpoint and resilience specs
are later slices.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from concurrent.futures import TimeoutError as FuturesTimeout
from typing import Any, Callable, Dict, Iterable, List, Optional

import torch

from repro_torch import device as device_lib
from repro_torch.core import kfac as kfac_lib
from repro_torch.core import kfactor
from repro_torch.models import layers
from repro_torch.optim import base as optbase

Tensor = torch.Tensor

#: heavy-op worker threads of an AsyncInverseRunner (the reference uses
#: 2).  The heavy op and the training step are both host-bound Python
#: under one interpreter lock, so a second worker cannot shorten the
#: heavy work on the card (PERF.md, PR 18).
_WORKERS = 1


@dataclasses.dataclass
class TrainState:
    params: Dict[str, Tensor]
    opt: Any                     # KfacState, or a baseline's state
    rng: torch.Generator


def kfac_grads(loss_fn, params, probes, batch):
    """(loss, acts, grads w.r.t. params, grads w.r.t. probes) from one
    backward pass.  ``acts`` come back detached."""
    loss, acts = loss_fn(params, probes, batch)
    pk, qk = list(params), list(probes)
    grads = torch.autograd.grad(loss, [params[k] for k in pk]
                                + [probes[k] for k in qk])
    gp = dict(zip(pk, grads[:len(pk)]))
    gprobe = dict(zip(qk, grads[len(pk):]))
    return (loss.detach(), {k: v.detach() for k, v in acts.items()}, gp,
            gprobe)


def make_scheduled_kfac_step(loss_fn: Callable, opt: kfac_lib.Kfac,
                             n_tokens: int, probe_dtype=torch.float32):
    """Returns step(state, batch, work, draws=None, landing=None) →
    (state, loss), with ``work`` the step's StepWork mask and ``landing``
    the pre-computed heavy results of its land ranges (see
    :class:`AsyncInverseRunner`; ``None`` lands in line).  Parameters are
    updated in place."""

    def step(state: TrainState, batch, work, draws=None, landing=None):
        dev = next(iter(state.params.values())).device
        probes = layers.make_probes(opt.taps, device=dev, dtype=probe_dtype)
        loss, acts, gp, gprobe = kfac_grads(loss_fn, state.params, probes,
                                            batch)
        updates, opt_state = opt.update(
            gp, state.opt, state.params, acts=acts, probe_grads=gprobe,
            n_tokens=n_tokens, rng=state.rng, work=work, draws=draws,
            landing=landing)
        optbase.apply_updates(state.params, updates)
        return dataclasses.replace(state, opt=opt_state), loss

    return step


class AsyncInverseRunner:
    """Overlapped dispatch for the async heavy pipeline (reference
    ``train/loop.py:145``).

    ``launch(opt_state, work)`` — call right AFTER the step that ran
    ``work`` (its launch ranges wrote the snapshots read here): clones
    each launched range of the in-flight buffer on the current stream and
    submits ``kfactor.heavy_from_snapshot`` on the clone to a worker
    thread.  On the card the worker runs it under ``torch.cuda.stream``
    of the runner's side stream, which first waits on an event recorded
    after the clone; the clone is ``record_stream``-ed to the side stream,
    so the allocator cannot hand its memory to the next step while the
    side stream still reads it.  The worker waits for its own stream, so
    every small eigh's host check blocks only the worker.

    ``landing(work)`` — call right BEFORE the step that runs ``work``:
    waits (at most the deadline) for this step's land ranges and returns
    the ``landing`` operand of ``Kfac.update``.  On the card the current
    stream waits on the event the worker recorded after the heavy op, and
    the landed tensors are ``record_stream``-ed to it.

    A landing that misses — no pending launch (``resume``), a deadline
    passed (``timeout``), the worker raised (``crash``) or the pipeline
    was dropped — maps to ``None`` and lands in line from the same
    snapshot, which gives the same result; after a timeout or a crash the
    worker pool is respawned (``last_error`` keeps a crash's exception).
    The deadline is ``deadline_s`` when set, else ``deadline_factor`` ×
    the median heavy time so far (floored at ``min_deadline_s``; 60 s
    before the first).  ``health`` counts launched, landed and missed
    ranges, respawns, and misses by reason; ``durations`` holds each
    range's heavy time in seconds (worker clock, from start to its
    stream's completion), in order of completion.  ``writer`` (telemetry)
    is a later slice: only ``None`` is accepted.

    One worker thread runs the heavy ops (``_WORKERS``).  ``close()``
    returns at once, as the reference's does: ranges not yet started are
    cancelled, and one already running finishes in the background, so a
    hung heavy op cannot hold up the end of training.
    """

    def __init__(self, opt: kfac_lib.Kfac, stream=None, writer=None,
                 deadline_s: Optional[float] = None,
                 deadline_factor: float = 4.0, min_deadline_s: float = 5.0):
        if writer is not None:
            raise ValueError("telemetry writers are not ported yet")
        self.opt = opt
        self.stream = stream
        self.deadline_s = deadline_s
        self.deadline_factor = deadline_factor
        self.min_deadline_s = min_deadline_s
        self.health = {"launched": 0, "landed": 0, "missed": 0,
                       "respawns": 0, "miss_reasons": {}}
        self.durations: List[float] = []
        self.last_error: Optional[BaseException] = None
        self._lock = threading.Lock()
        self._pool = ThreadPoolExecutor(max_workers=_WORKERS)
        self._pending: Dict = {}
        self._dropped: Dict = {}        # range → miss reason tombstone

    @classmethod
    def for_opt(cls, opt: kfac_lib.Kfac, writer=None
                ) -> Optional["AsyncInverseRunner"]:
        """A runner for ``opt`` — on the card with a side stream of the
        lowest priority — or None when the optimizer does not pipeline
        (a synchronous config)."""
        if not opt._async_buckets:
            return None
        stream = None
        if opt.device.type == "cuda":
            lowest, _ = torch.cuda.Stream.priority_range()
            stream = torch.cuda.Stream(device=opt.device, priority=lowest)
        return cls(opt, stream=stream, writer=writer)

    def _run(self, bi: int, count: int, snap: kfactor.InflightState,
             ready):
        spec = self.opt.factor_buckets[bi].spec
        t0 = time.perf_counter()
        done = None
        if self.stream is None:
            out = kfactor.heavy_from_snapshot(spec, snap, 0, count)
        else:
            with torch.cuda.stream(self.stream):
                self.stream.wait_event(ready)
                out = kfactor.heavy_from_snapshot(spec, snap, 0, count)
                done = torch.cuda.Event()
                done.record(self.stream)
            done.synchronize()
        with self._lock:
            self.durations.append(time.perf_counter() - t0)
        return out, done

    def _deadline(self) -> float:
        if self.deadline_s is not None:
            return self.deadline_s
        with self._lock:
            durations = sorted(self.durations)
        if durations:
            med = durations[len(durations) // 2]
            return max(self.min_deadline_s, self.deadline_factor * med)
        return max(self.min_deadline_s, 60.0)

    def _respawn(self) -> None:
        """Replace a hung or crashed worker pool; tasks already running
        keep their threads and land if they finish in time."""
        self._pool.shutdown(wait=False, cancel_futures=True)
        self._pool = ThreadPoolExecutor(max_workers=_WORKERS)
        self.health["respawns"] += 1

    def _submit(self, *args):
        try:
            return self._pool.submit(self._run, *args)
        except RuntimeError:            # the pool died between steps
            self._respawn()
            return self._pool.submit(self._run, *args)

    def drop_pending(self, reason: str = "dropped") -> None:
        """Abandon every pending range: its landing misses with
        ``reason`` and lands in line."""
        for key, fut in list(self._pending.items()):
            fut.cancel()
            self._dropped[key] = reason
        self._pending.clear()

    def _miss(self, reason: str) -> None:
        self.health["missed"] += 1
        reasons = self.health["miss_reasons"]
        reasons[reason] = reasons.get(reason, 0) + 1

    def launch(self, opt_state: kfac_lib.KfacState, work) -> None:
        for bi, ranges in enumerate(work.launch):
            for lo, hi in ranges:
                snap = opt_state.inflight[str(bi)].map(
                    lambda x: x[lo:hi].clone())
                ready = None
                if self.stream is not None:
                    ready = torch.cuda.Event()
                    ready.record()
                    for t in vars(snap).values():
                        t.record_stream(self.stream)
                self._pending[(bi, lo, hi)] = self._submit(bi, hi - lo,
                                                           snap, ready)
                self.health["launched"] += 1

    def landing(self, work):
        out = {}
        for bi, ranges in enumerate(work.land):
            if not ranges:
                continue
            results = []
            for lo, hi in ranges:
                key = (bi, lo, hi)
                fut = self._pending.pop(key, None)
                if fut is None:
                    results.append(None)
                    self._miss(self._dropped.pop(key, "resume"))
                    continue
                try:
                    res, done = fut.result(timeout=self._deadline())
                except FuturesTimeout:
                    fut.cancel()
                    results.append(None)
                    self._miss("timeout")
                    self._respawn()
                    continue
                except Exception as e:  # the worker raised: land in line
                    self.last_error = e
                    results.append(None)
                    self._miss("crash")
                    self._respawn()
                    continue
                if done is not None:
                    cur = torch.cuda.current_stream()
                    cur.wait_event(done)
                    for t in res:
                        t.record_stream(cur)
                results.append(res)
                self.health["landed"] += 1
            out[str(bi)] = tuple(results)
        return out or None

    def close(self) -> None:
        self._pool.shutdown(wait=False, cancel_futures=True)


def make_baseline_step(loss_fn: Callable, opt):
    """Step for probe-free optimizers (SGD, AdamW): step(state, batch) →
    (state, loss), parameters updated in place (reference
    ``train/loop.py:329``)."""

    def step(state: TrainState, batch):
        loss, _ = loss_fn(state.params, {}, batch)
        keys = list(state.params)
        grads = dict(zip(keys, torch.autograd.grad(
            loss, [state.params[k] for k in keys])))
        updates, opt_state = opt.update(grads, state.opt, state.params)
        optbase.apply_updates(state.params, updates)
        return dataclasses.replace(state, opt=opt_state), loss.detach()

    return step


def run_kfac_training(loss_fn, opt: kfac_lib.Kfac, params: Dict[str, Tensor],
                      batches: Iterable, n_tokens: int, seed: int = 0,
                      callback=None, device=None,
                      draws: Optional[Callable[[int], Dict]] = None,
                      overlap=False):
    """Drive the scheduled steps over ``batches`` (the work scheduler picks
    each step's mask; ``cfg.stagger`` phases heavy work,
    ``cfg.async_heavy``/``heavy_lag`` pipeline it).  ``device=None`` means
    the card, and a host without one raises; the parameters must already
    live on the device.  ``draws(step)`` optionally injects the heavy
    ops' random inputs per bucket (parity tests); otherwise they come from
    a generator seeded with ``seed``.  ``overlap=True`` dispatches the
    launched heavy work through an :class:`AsyncInverseRunner` built by
    ``for_opt`` (None for a synchronous config); a runner passed as
    ``overlap`` is used instead, so the caller can read its ``health``.
    Either way landings give the same result as in line.  Returns (final
    TrainState, losses as floats); ``callback(k, state, loss)`` sees the
    loss as a device tensor."""
    dev = device_lib.resolve(device)
    wrong = [k for k, p in params.items() if p.device.type != dev.type]
    if wrong:
        raise ValueError(f"parameters {wrong[:3]} are not on {dev}")
    sched = opt.scheduler()
    state = TrainState(params=params, opt=opt.init(params),
                       rng=torch.Generator(device=dev).manual_seed(seed))
    step_fn = make_scheduled_kfac_step(loss_fn, opt, n_tokens)
    runner = (overlap if isinstance(overlap, AsyncInverseRunner)
              else AsyncInverseRunner.for_opt(opt) if overlap else None)
    losses: List[Tensor] = []
    try:
        for k, batch in enumerate(batches):
            work = sched.work(k)
            landing = runner.landing(work) if runner is not None else None
            state, loss = step_fn(state, batch, work,
                                  draws=None if draws is None else draws(k),
                                  landing=landing)
            if runner is not None:
                runner.launch(state.opt, work)
            losses.append(loss)
            if callback is not None:
                callback(k, state, loss)
    finally:
        if runner is not None:
            runner.close()
    return state, [float(x) for x in losses]
