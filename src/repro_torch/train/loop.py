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

:func:`run_kfac_training` takes the reference's whole option surface:
``state=`` (resume), the four ``repro_torch.specs`` objects (``obs``
telemetry and metrics, ``ckpt`` checkpoints, ``resilience`` health
guards, remediation ladder and chaos, ``dist`` the distributed curvature
engine on a mesh) and the legacy flat kwargs.
"""
from __future__ import annotations

import dataclasses
import math
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from concurrent.futures import TimeoutError as FuturesTimeout
from typing import Any, Callable, Dict, Iterable, List, Optional

import torch
import torch.distributed

from repro_torch import device as device_lib
from repro_torch import specs as specs_lib
from repro_torch.core import kfac as kfac_lib
from repro_torch.core import kfactor
from repro_torch.distributed import collectives as coll
from repro_torch.models import layers
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
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


def kfac_grads(loss_fn, params, probes, batch, sp=None,
               reduce_grads: bool = True, keep_blocks=()):
    """(loss, acts, grads w.r.t. params, grads w.r.t. probes) from one
    backward pass.  ``acts`` come back detached.

    With a data-parallel policy ``sp`` (``models/sharding_policy.py``)
    ``batch`` is this rank's block of the global batch and ``loss_fn``
    returns this rank's share of the global loss (``LM.loss_fn``): the
    loss, the acts and the probe gradients (each rank's rows at their
    global places, ``layers.tapped_matmul``) are summed over the data
    axes, so every rank gets the global batch's loss and statistics rows;
    so are the parameter gradients unless ``reduce_grads`` is False (a
    gradient transform that reduces them itself, such as
    ``compress.compress_tree(sp=)``, then gets each rank's share).

    Under tensor parallelism (``sp.model_parallel``; ``sp`` the LM's
    policy, whose ``shards`` say which parameters are blocks) the loss is
    each model rank's 1/M share, the acts come back gathered
    (``LM.loss_fn``), the probe gradients of column-parallel and expert
    taps are the ranks' blocks (``ModelShards.probe_dim``): those of the
    taps in ``keep_blocks`` stay the rank's block (``Kfac.probe_blocks``:
    a column-parallel tap whose G factor the rank holds by rows needs only
    its rows of X_G), the others are gathered over the model axis in one
    packed collective.  The loss, the other probe gradients (a
    row-parallel tap's is model rank 0's) and the gradients of the
    parameters replicated over the model axis (each rank's part: a norm
    scale ahead of ``full_seq`` sees only its T-block) are summed over
    every axis in one packed pass; a sharded parameter's gradient is the
    rank's block, whole over "model", and is summed over the data axes
    only, as are the probe gradients' blocks, kept or gathered."""
    loss, acts = loss_fn(params, probes, batch)
    pk, qk = list(params), list(probes)
    grads = torch.autograd.grad(loss, [params[k] for k in pk]
                                + [probes[k] for k in qk])
    gp = dict(zip(pk, grads[:len(pk)]))
    gprobe = dict(zip(qk, grads[len(pk):]))
    loss = loss.detach()
    acts = {k: v.detach() for k, v in acts.items()}
    if sp is not None and sp.model_parallel:
        ms = sp.shards
        loss = loss.clone()
        dims = {k: ms.probe_dim(k) for k in gprobe}
        blocks = [k for k in gprobe if dims[k] is not None]
        kept = [k for k in blocks if k in keep_blocks]
        gathered = [k for k in blocks if k not in keep_blocks]
        gprobe.update({k: sp.block(gprobe[k], dims[k]).contiguous()
                       for k in kept})
        gprobe.update(zip(gathered, coll.all_gather_coalesced(
            [sp.block(gprobe[k], dims[k]) for k in gathered], sp.mesh,
            sp.tp, [dims[k] for k in gathered])))
        rep = [g for k, g in gp.items() if not ms.sharded(k)]
        every = [loss] + [g for k, g in gprobe.items() if dims[k] is None]
        local = list(acts.values()) + [gprobe[k] for k in blocks]
        if reduce_grads:
            coll.all_reduce_coalesced(every + rep, sp.mesh, None)
            sp.dp_sum_all(local + [g for k, g in gp.items()
                                   if ms.sharded(k)])
        else:           # the transform sums the gradients over the data axes
            coll.all_reduce_coalesced(every, sp.mesh, None)
            coll.all_reduce_coalesced(rep, sp.mesh, sp.tp)
            sp.dp_sum_all(local)
    elif sp is not None and sp.data_parallel:
        loss = loss.clone()
        sp.dp_sum_all([loss] + list(acts.values()) + list(gprobe.values())
                      + (list(gp.values()) if reduce_grads else []))
    return loss, acts, gp, gprobe


def gathered_tap_bytes(taps, act_bytes: int = 4) -> int:
    """Bytes a data-parallel step sums over the data axes for the taps
    (``kfac_grads``): each stacked slot's acts, (n_stat, d_in) in the
    activations' dtype (``act_bytes`` an entry), and probe gradients,
    (n_stat, d_out) fp32."""
    return sum(math.prod(t.stack) * t.n_stat
               * (act_bytes * t.d_in + 4 * t.d_out) for t in taps.values())


def make_kfac_step(loss_fn: Callable, opt: kfac_lib.Kfac, n_tokens: int,
                   probe_dtype=torch.float32):
    """DEPRECATED legacy three-bool step factory (reference
    ``train/loop.py:55``): converts the flags with ``opt.uniform_work``
    and delegates to :func:`make_scheduled_kfac_step` — the same
    numbers.  Returns step(state, batch, do_stats, do_light, do_heavy)
    → (state, loss)."""
    specs_lib.warn_once(
        "make_kfac_step",
        "make_kfac_step is deprecated; use make_scheduled_kfac_step with "
        "a StepWork mask (opt.uniform_work / opt.scheduler().work)")
    scheduled = make_scheduled_kfac_step(loss_fn, opt, n_tokens,
                                         probe_dtype=probe_dtype)

    def step(state: TrainState, batch, do_stats: bool, do_light: bool,
             do_heavy: bool):
        work = opt.uniform_work(bool(do_stats), bool(do_light),
                                bool(do_heavy))
        return scheduled(state, batch, work)

    return step


def make_scheduled_kfac_step(loss_fn: Callable, opt: kfac_lib.Kfac,
                             n_tokens: int, probe_dtype=torch.float32,
                             meter: Optional[obs_metrics.Meter] = None,
                             grad_transform: Optional[Callable] = None,
                             obs: Optional[specs_lib.ObsSpec] = None,
                             sp=None):
    """Returns step(state, batch, work, draws=None, landing=None) →
    (state, loss), with ``work`` the step's StepWork mask and ``landing``
    the pre-computed heavy results of its land ranges (see
    :class:`AsyncInverseRunner`; ``None`` lands in line).  Parameters are
    updated in place.

    With a ``meter`` (or an ``obs`` spec whose ``make_meter`` builds one)
    the step becomes step(state, batch, work, draws=None, landing=None,
    mbuf=None) → (state, loss, mbuf): the optimizer runs under the
    meter's collector, the metric buffer is merged and flushed, and the
    parameters and loss are bit for bit the meter-less step's.

    ``grad_transform`` — ``(grads, carry) -> (grads, carry)`` — rewrites
    the parameter gradients before the optimizer sees them (the DP
    gradient-compression path: ``distributed/compress.py::compress_tree``
    with its ``CompressState`` carry); the step then takes and returns
    that carry as a trailing argument and output (``cstate=``, after
    ``mbuf`` when a meter is on).

    ``sp``: the model's policy; under data parallelism the step runs
    :func:`kfac_grads` with it (the batch is this rank's block), and a
    ``grad_transform`` gets each rank's share of the gradients and must
    return the reduced ones, as ``compress_tree(sp=)`` does."""
    if obs is not None and meter is None:
        meter = obs.make_meter(opt)

    def step(state: TrainState, batch, work, draws=None, landing=None,
             mbuf=None, cstate=None):
        dev = next(iter(state.params.values())).device
        probes = layers.make_probes(opt.taps, device=dev, dtype=probe_dtype)
        loss, acts, gp, gprobe = kfac_grads(
            loss_fn, state.params, probes, batch, sp,
            reduce_grads=grad_transform is None,
            keep_blocks=opt.probe_blocks())
        if grad_transform is not None:
            gp, cstate = grad_transform(gp, cstate)
        # the step owns gp: the update may drop each gradient once its
        # bucket is gathered
        kw = dict(acts=acts, probe_grads=gprobe, n_tokens=n_tokens,
                  rng=state.rng, work=work, draws=draws, landing=landing,
                  consume_grads=True)
        if meter is None:
            updates, opt_state = opt.update(gp, state.opt, state.params,
                                            **kw)
        else:
            with meter.collecting() as col:
                updates, opt_state = opt.update(gp, state.opt,
                                                state.params, **kw)
            mbuf = meter.maybe_flush(meter.merge(mbuf, col),
                                     opt_state.step)
        optbase.apply_updates(state.params, updates)
        outs = (dataclasses.replace(state, opt=opt_state), loss)
        if meter is not None:
            outs += (mbuf,)
        if grad_transform is not None:
            outs += (cstate,)
        return outs

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
    stream's completion), in order of completion.  A
    :class:`repro_torch.obs.TelemetryWriter` passed as ``writer`` gets
    the reference's per-range ``async_launch`` / ``async_land`` /
    ``async_miss`` events (a miss carries its ``reason``); the heavy op
    runs inside the profiler span ``async/heavy/b{bi}``.

    One worker thread runs the heavy ops (``_WORKERS``).  ``close()``
    returns at once, as the reference's does: ranges not yet started are
    cancelled, and one already running finishes in the background, so a
    hung heavy op cannot hold up the end of training.
    """

    def __init__(self, opt: kfac_lib.Kfac, stream=None, writer=None,
                 deadline_s: Optional[float] = None,
                 deadline_factor: float = 4.0, min_deadline_s: float = 5.0):
        self.opt = opt
        self.writer = writer
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
        (a synchronous config, or a curvature engine attached: the engine
        lands inside its own program)."""
        if not opt._async_buckets or opt.curvature is not None:
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
        with obs_trace.host_span(f"async/heavy/b{bi}"):
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

    def _miss(self, key, reason: str, step) -> None:
        self.health["missed"] += 1
        reasons = self.health["miss_reasons"]
        reasons[reason] = reasons.get(reason, 0) + 1
        if self.writer is not None:
            bi, lo, hi = key
            self.writer.emit("async_miss", step=int(step or 0), bucket=bi,
                             lo=lo, hi=hi, reason=reason)

    def launch(self, opt_state: kfac_lib.KfacState, work,
               step: Optional[int] = None) -> None:
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
                if self.writer is not None:
                    self.writer.emit("async_launch", step=int(step or 0),
                                     bucket=bi, lo=lo, hi=hi)

    def landing(self, work, step: Optional[int] = None):
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
                    self._miss(key, self._dropped.pop(key, "resume"), step)
                    continue
                overlapped = fut.done()
                try:
                    res, done = fut.result(timeout=self._deadline())
                except FuturesTimeout:
                    fut.cancel()
                    results.append(None)
                    self._miss(key, "timeout", step)
                    self._respawn()
                    continue
                except Exception as e:  # the worker raised: land in line
                    self.last_error = e
                    results.append(None)
                    self._miss(key, "crash", step)
                    self._respawn()
                    continue
                if done is not None:
                    cur = torch.cuda.current_stream()
                    cur.wait_event(done)
                    for t in res:
                        t.record_stream(cur)
                results.append(res)
                self.health["landed"] += 1
                if self.writer is not None:
                    self.writer.emit("async_land", step=int(step or 0),
                                     bucket=bi, lo=lo, hi=hi,
                                     overlapped=bool(overlapped))
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


@torch.no_grad()
def _adopt_params(live: Dict[str, Tensor], restored: Dict[str, Tensor]
                  ) -> Dict[str, Tensor]:
    """Copy restored parameter values into the live tensors (the caller's
    model keeps training the tensors it handed in) → ``live``."""
    for k, p in live.items():
        p.copy_(restored[k])
    return live


def run_kfac_training(loss_fn, opt: kfac_lib.Kfac,
                      params: Optional[Dict[str, Tensor]], batches: Iterable,
                      n_tokens: int, seed: int = 0, callback=None,
                      state: Optional[TrainState] = None, overlap=False,
                      dist: Optional[specs_lib.DistSpec] = None,
                      obs: Optional[specs_lib.ObsSpec] = None,
                      ckpt: Optional[specs_lib.CkptSpec] = None,
                      resilience: Optional[specs_lib.ResilienceSpec] = None,
                      device=None,
                      draws: Optional[Callable[[int], Dict]] = None,
                      **legacy):
    """Drive the scheduled steps over ``batches`` (the work scheduler picks
    each step's mask; ``cfg.stagger`` phases heavy work,
    ``cfg.async_heavy``/``heavy_lag`` pipeline it) — the reference's
    ``run_kfac_training`` step for step (``src/repro/train/loop.py:405``).

    ``device=None`` means the card, and a host without one raises; the
    parameters must already live on the device.  ``draws(step)``
    optionally injects the heavy ops' random inputs per bucket, keyed by
    schedule step (parity tests); otherwise they come from the state's
    generator, seeded with ``seed``.  ``overlap=True`` dispatches launched
    heavy work through an :class:`AsyncInverseRunner` built by ``for_opt``
    (None for a synchronous config); a runner passed as ``overlap`` is
    used instead.  Either way landings give the same result as in line.

    Passing a restored ``state`` resumes (``params`` may then be None):
    the schedule position is re-derived from ``state.opt.phase``, and an
    async config's in-flight snapshots restore with it, so a landing
    scheduled before the save fires on time after the restore.

    ``obs`` (:class:`~repro_torch.specs.ObsSpec`) — its writer receives a
    ``step`` event per step and the async runner's events;
    ``metrics_every > 0`` adds a device-resident
    :class:`~repro_torch.obs.metrics.Meter` flushed to the writer every
    that many steps.  Both are numerically inert.

    ``resilience`` (:class:`~repro_torch.specs.ResilienceSpec`) — health
    (truthy, or a :class:`~repro_torch.train.health.HealthConfig`) swaps
    in the guarded step and drives the remediation ladder: skip →
    damping escalation → forced heavy refresh → rollback (the last needs
    a ``ckpt`` spec); ``policy`` rides a caller-built
    :class:`~repro_torch.train.health.RemediationPolicy`; ``chaos`` (a
    :class:`~repro_torch.train.chaos.ChaosMonkey`) injects its faults,
    keyed on the loop iteration ``k``.  A healthy run with health on is
    bit for bit the run with it off.

    ``ckpt`` (:class:`~repro_torch.specs.CkptSpec`) — a checkpoint every
    ``ckpt.every`` healthy schedule steps into ``ckpt.dir`` (pruned to
    ``ckpt.keep``); rollbacks restore from there, walking past corrupted
    snapshots, and copy the restored parameters into the live tensors.

    ``dist`` (:class:`~repro_torch.specs.DistSpec`) — mesh +
    curvature_axis attach the distributed curvature engine, so factor
    work shards across that mesh axis (row_axis adds the 2D path,
    curvature_compress the compressed gathers).  Every member runs this
    loop on the same batches; only rank 0 writes telemetry and
    checkpoint files, and a checkpoint holds the gathered global state
    (the one-device format).  A passed ``state`` in the one-device
    layout is laid out for the engine first.
    The legacy flat kwargs (``writer=``, ``ckpt_dir=``, …) warn once and
    fold into their specs.  Returns (final TrainState, losses as floats);
    ``callback(k, state, loss)`` sees the loss as a device tensor."""
    from repro_torch.train import checkpoint as ckpt_lib
    from repro_torch.train import health as health_lib
    dist, obs, ckpt, resilience = specs_lib.consolidate_training_kwargs(
        legacy, dist=dist, obs=obs, ckpt=ckpt, resilience=resilience,
        caller="run_kfac_training")
    engine = dist.attach(opt)
    dev = device_lib.resolve(device)
    rank0 = engine is None or torch.distributed.get_rank() == 0
    if not rank0 and obs.writer is not None:
        # the other members keep the writer's calls (the metrics meter
        # reduces over the mesh) but write nothing
        from repro_torch.obs import events as obs_events
        obs = dataclasses.replace(obs, writer=obs_events.TelemetryWriter(
            console=False))
    writer = obs.writer
    health, policy, chaos = (resilience.health, resilience.policy,
                             resilience.chaos)
    sched = opt.scheduler()
    k_off = 0
    if state is None:
        wrong = [k for k, p in params.items() if p.device.type != dev.type]
        if wrong:
            raise ValueError(f"parameters {wrong[:3]} are not on {dev}")
        state = TrainState(params=params, opt=opt.init(params),
                           rng=torch.Generator(device=dev).manual_seed(seed))
    else:
        k_off = int(state.opt.phase)
        if engine is not None and not state.opt.shards:
            state = dataclasses.replace(
                state, opt=engine.localize_state(opt, state.opt))
    shardings = (None if engine is None else
                 TrainState(params=None, opt=engine.state_sharding(opt),
                            rng=None))
    runner = (overlap if isinstance(overlap, AsyncInverseRunner)
              else AsyncInverseRunner.for_opt(opt, writer=writer)
              if overlap else None)
    meter = obs.make_meter(opt)
    if health or policy is not None:
        hcfg = health if isinstance(health, health_lib.HealthConfig) \
            else None
        if policy is None:
            policy = health_lib.RemediationPolicy(hcfg, writer=writer)
        step_fn = health_lib.make_resilient_kfac_step(
            loss_fn, opt, n_tokens, health=policy.cfg, meter=meter)
    else:
        step_fn = make_scheduled_kfac_step(loss_fn, opt, n_tokens,
                                           meter=meter)
    mbuf = meter.init() if meter is not None else None
    losses: List[Tensor] = []
    try:
        for k, batch in enumerate(batches):
            kk = k_off + k
            # chaos faults are keyed on the loop iteration k, not the
            # schedule step kk: a rollback re-anchors kk into the past,
            # and external faults must not replay with it
            if chaos is not None:
                chaos.check(k)                    # host_loss raises here
                batch = chaos.corrupt_batch(k, batch)
                state = chaos.corrupt_state(k, state)
            work = sched.work(kk)
            if policy is not None and policy.take_refresh():
                # stage 2: abandon the (possibly poisoned) pipeline and
                # re-establish the inverse rep from the live M this step
                work = opt.remedial_work()
                state = dataclasses.replace(
                    state, opt=opt.clear_inflight(state.opt))
                if runner is not None:
                    runner.drop_pending(reason="dropped")
            if runner is not None and chaos is not None:
                chaos.harass_runner(k, runner)
            landing = (runner.landing(work, step=kk) if runner is not None
                       else None)
            t0 = time.perf_counter()
            kw = dict(draws=None if draws is None else draws(kk),
                      landing=landing)
            if meter is not None:
                kw["mbuf"] = mbuf
            report = None
            if policy is not None:
                out = step_fn(state, batch, work,
                              damping_scale=policy.damping_scale, **kw)
                state, loss, report = out[:3]
            else:
                out = step_fn(state, batch, work, **kw)
                state, loss = out[:2]
            if meter is not None:
                mbuf = out[-1]
            if runner is not None:
                runner.launch(state.opt, work, step=kk)
            losses.append(loss)
            if writer is not None:
                writer.emit("step", step=kk, loss=float(loss),
                            dt_s=time.perf_counter() - t0, phase=work.label)
            faulty = False
            if policy is not None:
                faulty = policy.observe(kk, float(loss), report)
                if policy.take_rollback() and ckpt.dir is not None:
                    # stage 3: restore the newest snapshot that verifies,
                    # walking past corrupt ones; re-anchor the schedule
                    # on the restored phase
                    if runner is not None:
                        runner.drop_pending(reason="dropped")
                    restored, man = ckpt_lib.restore_latest_healthy(
                        ckpt.dir, state, shardings=shardings)
                    state = dataclasses.replace(restored, params=(
                        _adopt_params(state.params, restored.params)))
                    k_off = int(state.opt.phase) - (k + 1)
                    policy.notify_rollback(kk, man["step"], ckpt.dir)
                    if writer is not None:
                        # beyond the reference's fields: the steps of the
                        # snapshots walked past
                        writer.emit("ckpt_restore", step=int(man["step"]),
                                    path=ckpt.dir, skipped_corrupt=[
                                        e["step"] for e in
                                        man["skipped_corrupt"]])
                    faulty = False          # restored state is healthy
            if (ckpt.dir is not None and ckpt.every > 0 and not faulty
                    and kk % ckpt.every == 0):
                tree = (state if engine is None else dataclasses.replace(
                    state, opt=engine.gather_state(opt, state.opt)))
                if rank0:
                    path = ckpt_lib.save(ckpt.dir, kk, tree)
                    ckpt_lib.prune(ckpt.dir, keep=ckpt.keep)
                    if writer is not None:
                        writer.emit("ckpt_save", step=kk, path=path)
                    if chaos is not None:
                        chaos.corrupt_ckpt(k, ckpt.dir)
                del tree
                if engine is not None:      # the file exists for everyone
                    torch.distributed.barrier(group=engine.mesh.group())
            if callback is not None:
                callback(k, state, loss)
        if meter is not None:
            meter.drain(mbuf, int(state.opt.step))
    finally:
        if runner is not None:
            runner.close()
    return state, [float(x) for x in losses]
