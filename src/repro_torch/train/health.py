"""Numerical-health guards + the staged remediation ladder.

Counterpart of ``src/repro/train/health.py``.  The safe response to almost
any numerical fault is "do less curvature work, never apply a poisoned
update", enacted in four escalating stages:

  stage 0  **skip**      — a step whose gradients, preconditioned updates
                           or post-step factor states hold nonfinite
                           values (or explode past a threshold) applies
                           *nothing*: the parameters and the whole
                           optimizer state stay as they were.
  stage 1  **escalate**  — persistent faults or loss divergence scale the
                           damping ratio φ up (``damping_scale`` into
                           ``Kfac.update``); de-escalates after
                           ``recovery_steps`` healthy steps.
  stage 2  **refresh**   — a forced out-of-cadence heavy refresh
                           (``Kfac.remedial_work``), every in-flight
                           snapshot discarded (``Kfac.clear_inflight``).
  stage 3  **rollback**  — restore the newest *healthy* checkpoint
                           (``checkpoint.restore_latest_healthy``).

**How the guard decides, in this port.**  The parameters are updated in
place (``optim/base.py::apply_updates``) and ``Kfac.update`` never
modifies the state it is given, so the guarded step computes the
update, builds the report, reads it on the host — one transfer, as the
reference's loop reads its report every step — and only then applies the
update and adopts the new state, or drops both.  Nothing is copied or
cloned for the guard.  The report's device work is a few fused
reductions (``torch._foreach_norm``: the sum and the largest magnitude
of each group of tensors); the exact nonfinite counts are taken only on
a step whose reductions are not finite.

**Inertness contract**: a healthy run with the guards on is bit for bit
the run with them off — the guard only reads, and the stage-1 knob
multiplies φ by exactly 1.0 until escalated
(tests/test_torch_resilience.py).

The policy (:class:`RemediationPolicy`) is the reference's host state
machine, line for line.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence

import torch

from repro_torch.core import kfactor
from repro_torch.distributed import collectives as coll
from repro_torch.models import layers
from repro_torch.obs import metrics as obs_metrics
from repro_torch.optim import base as optbase

Tensor = torch.Tensor

#: remediation-ladder stage codes (the ``stage`` field of
#: ``remediation`` telemetry events)
STAGE_SKIP = 0
STAGE_DAMP = 1
STAGE_REFRESH = 2
STAGE_ROLLBACK = 3
STAGE_ELASTIC = 4


@dataclasses.dataclass(frozen=True)
class HealthConfig:
    """Thresholds for the guards + ladder pacing (the reference's
    defaults); the ladder counters are in *consecutive faulty steps*."""
    grad_abs_max: float = 1e8        # |g|_max past this trips the guard
    update_abs_max: float = 1e8      # |Δ|_max past this trips the guard
    loss_div_factor: float = 30.0    # loss > factor × EMA ⇒ divergence
    loss_ema: float = 0.9            # EMA decay for the divergence ref
    ns_res_max: float = kfactor._NS_RES_MAX   # NS residual blowup
    escalation: float = 8.0          # φ multiplier per stage-1 action
    max_escalations: int = 2
    refresh_after: int = 3           # faulty streak ⇒ forced refresh
    rollback_after: int = 6          # faulty streak ⇒ checkpoint rollback
    recovery_steps: int = 4          # healthy streak ⇒ de-escalate φ


# ---------------------------------------------------------------------------
# the report
# ---------------------------------------------------------------------------

def _floats(tensors: Sequence[Tensor]) -> List[Tensor]:
    return [t for t in tensors if t.is_floating_point() and t.numel()]


def _sum_and_max(tensors: Sequence[Tensor], device) -> Tensor:
    """(Σ|x|, max|x|) over ``tensors`` as a (2,) fp32 device tensor —
    two fused launches; either is nonfinite iff an entry is (or the sum
    overflows, which only an entry past any threshold can cause)."""
    ts = _floats(tensors)
    if not ts:
        return torch.zeros(2, dtype=torch.float32, device=device)
    l1 = torch._foreach_norm(ts, 1)
    linf = torch._foreach_norm(ts, float("inf"))
    f32 = lambda xs: torch.stack([x.to(torch.float32) for x in xs])
    return torch.stack([f32(l1).sum(), f32(linf).max()])


def _count_nonfinite(tensors: Sequence[Tensor]) -> float:
    """Exact count of nonfinite entries (host read; faulty steps only)."""
    ts = _floats(tensors)
    if not ts:
        return 0.0
    return float(sum(torch.sum(~torch.isfinite(t)).to(torch.float32)
                     for t in ts))


def _factor_groups(opt, factors, shards=None):
    """Per factor bucket: (its tensors the guard checks that a rank holds
    by rows on the model axis, those it holds whole, the curvature
    engine's block of its dense M in ``shards`` as a list (empty without
    one), whether that block's rows are on the model axis, its NS
    residuals or None).  U's rows are on "model" where the model axis
    divides d; M's too, unless the engine keeps them on a row axis of its
    own (then every model rank holds the same block)."""
    out = []
    rows_of = getattr(opt, "_factor_rows", lambda spec: None)
    m_rows_of = getattr(opt, "_m_rows", lambda spec: None)
    for bi, bucket in enumerate(opt.factor_buckets):
        u_held = rows_of(bucket.spec) is not None
        m_held = m_rows_of(bucket.spec) is not None
        held, rep, res = [], [], []
        for e in bucket.entries:
            st = getattr(factors[e.name], e.side)
            (held if u_held else rep).append(st.U)
            if bucket.spec.needs_m:
                (held if m_held else rep).append(st.M)
            rep.append(st.D)
            if bucket.spec.mode is kfactor.Mode.NS:
                res.append(torch.max(st.aux[..., kfactor.AUX_RES]))
        shard = [shards[str(bi)]] if shards and str(bi) in shards else []
        out.append((held, rep, shard, m_held,
                    torch.stack(res).max() if res else None))
    return out


def _read(opt, loss: Tensor, groups: Dict, factors,
          shards=None) -> Dict[str, float]:
    """Device reductions for ``groups`` and the factor buckets, moved to
    the host in one transfer with the loss; exact counts where a
    reduction is not finite → {"loss", "<group>_nonfinite",
    "<group>_abs_max", "bucket{bi}/factor_nonfinite",
    "bucket{bi}/ns_res"}.  Under a curvature engine the factor sums are
    summed over the mesh (each member checks its own M block), so every
    member reaches the same verdict.  A group may be a dict keyed by
    parameter path; under tensor parallelism (``opt.model_shards``) the
    sums and maxima of its sharded leaves' blocks are reduced over the
    model axis and its replicated leaves count once, and so are those of
    the factor row blocks (U, M) and the replicated D."""
    dev = loss.device
    fgroups = _factor_groups(opt, factors, shards)
    parts = [loss.detach().to(torch.float32).reshape(1)]
    ms = getattr(opt, "model_shards", None)
    split = {}
    if ms is not None and groups:
        # a tree keyed by parameter path: its blocks of sharded leaves
        # are summed (maxed) over the model axis, its replicated leaves
        # count once
        for name, tree in groups.items():
            split[name] = ([x for k, x in tree.items() if ms.sharded(k)],
                           [x for k, x in tree.items() if not ms.sharded(k)])
        sh = torch.stack([_sum_and_max(a, dev) for a, _ in split.values()])
        sums = coll.all_reduce(sh[:, 0].contiguous(), ms.mesh, ms.axis)
        maxs = coll.all_reduce_max(sh[:, 1], ms.mesh, ms.axis)
        for (name, (_, r)), s_, m_ in zip(split.items(), sums, maxs):
            sr = _sum_and_max(r, dev)
            parts.append(torch.stack([s_ + sr[0], torch.maximum(m_, sr[1])]))
        groups = {k: list(v.values()) for k, v in groups.items()}
    else:
        groups = {k: list(v.values()) if isinstance(v, dict) else v
                  for k, v in groups.items()}
        parts += [_sum_and_max(ts, dev) for ts in groups.values()]
    fparts = [_sum_and_max(h + (sh if on_m else []), dev)
              for h, _, sh, on_m, _ in fgroups]
    if ms is not None and fparts:
        # the row blocks' sums and maxima over the model axis
        sh = torch.stack(fparts)
        sums = coll.all_reduce(sh[:, 0].contiguous(), ms.mesh, ms.axis)
        maxs = coll.all_reduce_max(sh[:, 1], ms.mesh, ms.axis)
        fparts = [torch.stack([s_, m_]) for s_, m_ in zip(sums, maxs)]
    fparts = [torch.stack([p[0] + q[0], torch.maximum(p[1], q[1])])
              for p, q in zip(fparts, (_sum_and_max(r + ([] if on_m else sh),
                                                    dev)
                                       for _, r, sh, on_m, _ in fgroups))]
    engine = getattr(opt, "curvature", None)
    if engine is not None and shards and fparts:
        # each engine member checks its own M block: summed over the
        # engine's axes (the model axis's row blocks are summed above)
        axes = tuple(a for a in (engine.axis, engine.row_axis) if a)
        sums = coll.all_reduce(torch.stack([p[0] for p in fparts]),
                               engine.mesh, axes)
        fparts = [torch.stack([s, p[1]]) for s, p in zip(sums, fparts)]
    parts += fparts
    parts += [r.to(torch.float32).reshape(1) for *_, r in fgroups
              if r is not None]
    vals = torch.cat(parts).cpu().tolist()              # the one transfer
    out = {"loss": vals[0]}
    i = 1
    finite = lambda s, m: math.isfinite(s) and math.isfinite(m)
    total = lambda x, mesh, axis: float(coll.all_reduce(
        torch.tensor([x], device=dev), mesh, axis)[0])
    for name, ts in groups.items():
        s, m = vals[i:i + 2]
        i += 2
        if finite(s, m):
            bad = 0.0
        elif name in split:
            bad = _count_nonfinite(split[name][1]) + total(
                _count_nonfinite(split[name][0]), ms.mesh, ms.axis)
        else:
            bad = _count_nonfinite(ts)
        out[f"{name}_nonfinite"] = bad
        out[f"{name}_abs_max"] = m
    for bi, (held, rep, shard, on_m, _) in enumerate(fgroups):
        s, m = vals[i:i + 2]
        i += 2
        bad = 0.0
        if not finite(s, m):
            # each entry counted once: a row block summed over "model",
            # the engine's M block over the engine's axes (and over
            # "model" too where its rows are there)
            n_held, n_shard = _count_nonfinite(held), _count_nonfinite(shard)
            if ms is not None:
                n_held = total(n_held, ms.mesh, ms.axis)
                if on_m and shard:
                    n_shard = total(n_shard, ms.mesh, ms.axis)
            if shard:
                n_shard = total(n_shard, engine.mesh, axes)
            bad = n_held + n_shard + _count_nonfinite(rep)
        out[f"bucket{bi}/factor_nonfinite"] = bad
    for bi, (*_, r) in enumerate(fgroups):
        if r is not None:
            out[f"bucket{bi}/ns_res"] = vals[i]
            i += 1
    return out


def factor_report(opt, factors, shards=None) -> Dict[str, float]:
    """Per-bucket factor-state checks off the live (post-step) states:
    nonfinite counts over (U, D[, M]) and, for NS buckets, the worst
    residual from the ``aux`` diagnostics → host floats."""
    dev = next(iter(factors.values())).A.U.device
    rep = _read(opt, torch.zeros((), device=dev), {}, factors, shards)
    del rep["loss"]
    return rep


def health_report(hcfg: HealthConfig, opt, loss: Tensor, grads, updates,
                  opt_state) -> Dict[str, float]:
    """The step's health vector, read on the host: a flat dict of floats
    with the reference's keys.  ``ok`` is the guard's verdict — 1.0 iff
    the step is safe to apply."""
    rep = _read(opt, loss, {"grad": dict(grads), "update": dict(updates)},
                opt_state.factors, opt_state.shards)
    loss_v = rep.pop("loss")
    factor_bad = sum(v for k, v in rep.items()
                     if k.endswith("factor_nonfinite"))
    ok = (math.isfinite(loss_v)
          and rep["grad_nonfinite"] == 0
          and rep["grad_abs_max"] < hcfg.grad_abs_max
          and rep["update_nonfinite"] == 0
          and rep["update_abs_max"] < hcfg.update_abs_max
          and factor_bad == 0)
    rep["ok"] = 1.0 if ok else 0.0
    return rep


def _record_health(report: Dict[str, float]) -> None:
    """Mirror the report into the metric buffer (no-op without an
    active collector)."""
    if not obs_metrics.active():
        return
    obs_metrics.record("health/guard_trips", 1.0 - report["ok"])
    obs_metrics.record("health/grad_nonfinite", report["grad_nonfinite"])
    obs_metrics.record("health/update_nonfinite",
                       report["update_nonfinite"])
    for k, v in report.items():
        if k.endswith("factor_nonfinite"):
            obs_metrics.record(f"health/{k}", v)


def make_resilient_kfac_step(loss_fn, opt, n_tokens: int,
                             health: Optional[HealthConfig] = None,
                             probe_dtype=torch.float32, meter=None,
                             sp=None):
    """``make_scheduled_kfac_step`` with the guard around it (``sp`` as
    there: under data parallelism the guard reads the global loss and
    gradients, reduced over the data axes).  Returns
    ``step(state, batch, work, draws=None, landing=None, mbuf=None,
    damping_scale=None) -> (state, loss, report[, mbuf])``.

    A step whose report says not-ok applies nothing: the parameters keep
    their values and the returned state is the one passed in (factors,
    in-flight buffers, counters), so a poisoned batch can neither move
    the parameters nor seed the curvature statistics.  ``damping_scale``
    is the ladder's stage-1 knob."""
    from repro_torch.train import loop as loop_lib
    hcfg = health if health is not None else HealthConfig()

    def step(state, batch, work, draws=None, landing=None, mbuf=None,
             damping_scale=None):
        dev = next(iter(state.params.values())).device
        probes = layers.make_probes(opt.taps, device=dev, dtype=probe_dtype)
        loss, acts, gp, gprobe = loop_lib.kfac_grads(
            loss_fn, state.params, probes, batch, sp,
            keep_blocks=opt.probe_blocks())

        def body():
            updates, opt_state = opt.update(
                gp, state.opt, state.params, acts=acts,
                probe_grads=gprobe, n_tokens=n_tokens, rng=state.rng,
                work=work, draws=draws, landing=landing,
                damping_scale=damping_scale)
            report = health_report(hcfg, opt, loss, gp, updates, opt_state)
            _record_health(report)
            if report["ok"] > 0:
                optbase.apply_updates(state.params, updates)
                return dataclasses.replace(state, opt=opt_state), report
            return state, report

        if meter is None:
            new, report = body()
            return new, loss, report
        with meter.collecting() as col:
            new, report = body()
        mbuf = meter.maybe_flush(meter.merge(mbuf, col), new.opt.step)
        return new, loss, report, mbuf

    return step


# ---------------------------------------------------------------------------
# the staged policy (host side)
# ---------------------------------------------------------------------------

class RemediationPolicy:
    """Consumes one :func:`health_report` per step and decides the next
    step's remediation.  Pure host-side state machine; every enacted
    action lands in ``self.actions`` and (when a writer is attached) as a
    ``remediation`` telemetry event.

    The trainer's contract (see ``loop.run_kfac_training``):

      * pass ``policy.damping_scale`` into the resilient step each step;
      * before building a step's work mask, if :meth:`take_refresh` is
        true, substitute ``opt.remedial_work()``, clear the in-flight
        buffers, and drop any pending async futures;
      * after the step, call :meth:`observe`;
      * if :meth:`take_rollback` is true, restore the newest healthy
        checkpoint and call :meth:`notify_rollback`.
    """

    def __init__(self, cfg: Optional[HealthConfig] = None, writer=None):
        self.cfg = cfg if cfg is not None else HealthConfig()
        self.writer = writer
        self.damping_scale: float = 1.0
        self.actions: List[dict] = []
        self._streak = 0
        self._healthy = 0
        self._escalations = 0
        self._loss_ema: Optional[float] = None
        self._refresh_pending = False
        self._rollback_pending = False

    # -- event plumbing ----------------------------------------------------
    def _emit(self, step: int, stage: int, action: str, detail: str):
        rec = dict(step=int(step), stage=int(stage), action=action,
                   detail=detail)
        self.actions.append(rec)
        if self.writer is not None:
            self.writer.emit("remediation", **rec)

    # -- per-step observation ----------------------------------------------
    def observe(self, step: int, loss: float,
                report: Dict[str, float]) -> bool:
        """Feed one step's (host) loss + health report.  Returns True iff
        the step was faulty."""
        cfg = self.cfg
        ok = report.get("ok", 1.0) >= 1.0
        diverged = not math.isfinite(loss)
        if not diverged and self._loss_ema is not None:
            diverged = loss > cfg.loss_div_factor * max(self._loss_ema,
                                                        1e-12)
        ns_blow = any(v >= cfg.ns_res_max for k, v in report.items()
                      if k.endswith("/ns_res"))
        fault = (not ok) or diverged or ns_blow
        if not fault:
            self._loss_ema = (loss if self._loss_ema is None else
                              cfg.loss_ema * self._loss_ema
                              + (1.0 - cfg.loss_ema) * loss)
            self._streak = 0
            self._healthy += 1
            if (self.damping_scale != 1.0
                    and self._healthy >= cfg.recovery_steps):
                self.damping_scale = 1.0
                self._escalations = 0
                self._emit(step, STAGE_DAMP, "deescalate",
                           f"healthy for {self._healthy} steps: damping "
                           f"scale -> 1")
            return False
        self._healthy = 0
        self._streak += 1
        why = []
        if not ok:
            why.append("in-graph guard tripped "
                       f"(grad_nonfinite={report.get('grad_nonfinite', 0):g}"
                       f", update_nonfinite="
                       f"{report.get('update_nonfinite', 0):g})")
        if diverged:
            ref = self._loss_ema if self._loss_ema is not None else 0.0
            why.append(f"loss divergence ({loss:.4g} vs ema {ref:.4g})")
        if ns_blow:
            why.append("NS residual blowup")
        detail = "; ".join(why)
        if not ok:
            self._emit(step, STAGE_SKIP, "skip",
                       f"update skipped in-graph: {detail}")
        if self._streak >= cfg.rollback_after:
            self._rollback_pending = True
            self._streak = 0
            self._emit(step, STAGE_ROLLBACK, "rollback",
                       f"{detail}; restoring newest healthy checkpoint")
        elif self._streak % cfg.refresh_after == 0:
            self._refresh_pending = True
            self._emit(step, STAGE_REFRESH, "refresh",
                       f"{detail}; forcing out-of-cadence heavy refresh "
                       f"(in-flight snapshots discarded)")
        elif self._escalations < cfg.max_escalations:
            self._escalations += 1
            old = self.damping_scale
            self.damping_scale = old * cfg.escalation
            self._emit(step, STAGE_DAMP, "escalate",
                       f"{detail}; damping scale {old:g} -> "
                       f"{self.damping_scale:g}")
        return True

    # -- trainer hooks ------------------------------------------------------
    def take_refresh(self) -> bool:
        """True once per scheduled forced refresh (consumed)."""
        pending, self._refresh_pending = self._refresh_pending, False
        return pending

    def take_rollback(self) -> bool:
        """True once per scheduled checkpoint rollback (consumed)."""
        pending, self._rollback_pending = self._rollback_pending, False
        return pending

    def notify_rollback(self, step: int, restored_step: int,
                        path: str) -> None:
        self._emit(step, STAGE_ROLLBACK, "restored",
                   f"rolled back to healthy step {restored_step} "
                   f"from {path}")

    def count(self, action: str) -> int:
        return sum(1 for a in self.actions if a["action"] == action)
