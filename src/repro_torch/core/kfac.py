"""The K-FAC optimizer family (K-FAC / R-KFAC / B-KFAC / B-R-KFAC /
B-KFAC-C / NS-KFAC) as one policy-driven optimizer, synchronous.

Counterpart of ``src/repro/core/kfac.py``.  The model contract is the
reference's: for every preconditioned matmul ``y = x @ W`` (W of shape
(d_in, d_out), possibly stacked) the model adds a zero *probe*
(*stack, n_stat, d_out) to an ``n_stat``-row slice of the output and emits
the matching inputs as ``acts`` (*stack, n_stat, d_in); the gradient with
respect to the probe is ∂L/∂y on that slice, so (acts, probe-grads) are
the K-factor square roots.

Parameters, gradients and updates are flat dicts keyed by the reference's
"/"-joined parameter paths ("fc0/w").  Step counters live on the host
(Python ints), so scheduling, damping and learning-rate reads never wait
on the card.  Each step's heavy work comes from a static
:class:`~repro_torch.core.schedule.StepWork` mask.

The bucketed path (one batched call per shape-class bucket) and the
per-tap comparison path (``bucketed=False``) run the same per-bucket
program.  Taps with ``linear_apply`` take the Alg-8 application from
their gradient factors.  ``async_heavy`` runs the two-phase launch/land
pipeline of the reference on the bucketed path (the per-bucket in-flight
buffers are ``KfacState.inflight``).  A distributed curvature engine
(``distributed/curvature.py``, attached as ``curvature``) takes over the
bucketed factor work and keeps each member's dense M in
``KfacState.shards``.

Telemetry, as in the reference: the update records the work and damping
metrics and, per bucket, the heavy-slot counts and refresh diagnostics
(``obs.metrics.record``, a no-op without an active collector: the
derived ones are computed only under one), and names its calls for the
profiler (``kfac/factor/b{bi}_{mode}``, ``kfac/precond/b{pbi}``).
``update(damping_scale=)`` is the remediation ladder's stage-1 knob.
"""
from __future__ import annotations

import dataclasses
import math
from typing import ClassVar, Dict, Optional, Tuple

import torch

from repro_torch import device as device_lib
from repro_torch import specs as specs_lib
from repro_torch.core import buckets, kfactor, policy, precond, schedule
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.optim import adamw as _adamw
from repro_torch.optim import base as optbase

Tensor = torch.Tensor
Params = Dict[str, Tensor]


@dataclasses.dataclass(frozen=True)
class TapInfo:
    """Static description of one tapped matmul family."""
    param_path: str                 # "/"-joined path to W
    d_in: int
    d_out: int
    stack: Tuple[int, ...] = ()
    n_stat: int = 512
    linear_apply: bool = False      # Alg 8: step from factors


@dataclasses.dataclass(frozen=True)
class KfacConfig:
    policy: policy.PolicyConfig = policy.PolicyConfig()
    lr: optbase.Schedule = optbase.constant(0.3)
    damping_phi: optbase.Schedule = optbase.constant(0.1)
    momentum: float = 0.0
    weight_decay: float = 7e-4
    clip: float = 0.07
    spectrum_continuation: bool = True
    use_kernels: bool = False       # route hot matmuls via kernels/ops.py
    bucketed: bool = True
    T_updt: int = 25
    T_inv: int = 250
    T_brand: int = 25
    T_rsvd: int = 250
    T_corct: int = 500
    stagger: bool = False
    stagger_splits: int = 1
    async_heavy: bool = False
    heavy_lag: int = 0
    fallback_lr: optbase.Schedule = optbase.constant(1e-3)
    fallback_wd: float = 0.0

    def flags(self, step: int) -> Dict[str, bool]:
        """DEPRECATED legacy three-bool view of the step variant; the
        scheduler's StepWork masks (``Kfac.scheduler().work(step)``)
        subsume it.  Warns once, then delegates to
        ``schedule.legacy_flags``."""
        specs_lib.warn_once(
            "KfacConfig.flags",
            "KfacConfig.flags(step) is deprecated; use "
            "Kfac.scheduler().work(step) (a StepWork mask) or "
            "Kfac.uniform_work(...)")
        return schedule.legacy_flags(self, step)


@dataclasses.dataclass
class TapState:
    A: kfactor.KFactorState      # forward factor
    G: kfactor.KFactorState      # backward factor


@dataclasses.dataclass
class KfacState:
    step: int
    n_stats: int
    phase: int                   # step mod schedule cycle
    factors: Dict[str, TapState]
    momentum: Optional[Params]
    fallback: _adamw.AdamWState
    # bucket idx (str) → the async pipeline's in-flight buffer; {} when
    # cfg.async_heavy is off
    inflight: Dict[str, kfactor.InflightState] = dataclasses.field(
        default_factory=dict)
    # bucket idx (str) → this mesh member's block of the bucket's dense M
    # (a curvature engine's layout, distributed/curvature.py); {} on one
    # device, so a checkpoint has no such leaves
    shards: Dict[str, Tensor] = dataclasses.field(default_factory=dict)
    # keyed by tap name (one checkpoint key each, as in the reference)
    TAP_KEYED: ClassVar[Tuple[str, ...]] = ("factors", "momentum")

    def factor_bytes(self) -> int:
        """Bytes of the factor state this rank holds: U, D, M and aux of
        every tap as held, and the curvature engine's M blocks."""
        return sum(x.numel() * x.element_size()
                   for ts in self.factors.values() for side in (ts.A, ts.G)
                   for x in (side.U, side.D, side.M, side.aux)) + sum(
            x.numel() * x.element_size() for x in self.shards.values())


#: the factor sides whose U a tensor-parallel step gathers whole, by the
#: tap's kind (``Kfac._precond_kind``)
_GATHERED = {"col": "A", "row": "G", "whole": "AG"}


class BucketLayout:
    """How a bucket's flat batch axis is laid out over the per-tap
    leaves: one optimizer's (entry-major, ``core/buckets.py``) here;
    ``core/tenant.py`` widens it with a tenant axis.  ``ranges`` maps the
    scheduler's slot ranges of a bucket into the batch, ``per_slot`` a
    step's damping ratio onto its slots, and ``scatter_states`` also gets
    the states it replaces."""

    gather = staticmethod(buckets.gather)
    scatter = staticmethod(buckets.scatter)
    gather_states = staticmethod(buckets.gather_states)

    @staticmethod
    def scatter_states(entries, batched, old):
        return buckets.scatter_states(entries, batched)

    @staticmethod
    def ranges(ranges):
        return ranges

    @staticmethod
    def per_slot(value, total: int):
        return value

    #: the caller hands its gradients over: they may be overwritten
    consumes = False

    @staticmethod
    def release(leaves, keys) -> None:
        """Called once ``leaves[k]`` for each k in ``keys`` has been
        gathered: a layout whose caller hands its gradients over may drop
        them."""


class _ConsumedGrads(BucketLayout):
    """The one-optimizer layout whose caller hands its gradients over
    (``Kfac.update(consume_grads=True)``): a bucket's tapped gradients
    leave the caller's dict once gathered (and a bucket's preconditioned
    step may be made in their storage)."""

    consumes = True

    @staticmethod
    def release(leaves, keys) -> None:
        for k in keys:
            leaves.pop(k, None)


class Kfac:
    """K-FAC optimizer over a tapped model (holds statics only).
    ``device=None`` means the card; its state lives there.

    ``curvature`` (optional) is a distributed curvature engine
    (``repro_torch.distributed.curvature.CurvatureEngine``) that shards
    each factor bucket's batch axis across a mesh axis; when attached,
    the bucketed factor work is delegated to it and :meth:`init` returns
    the state in its layout.  Duck-typed, so core never imports the
    distributed package.

    ``model_shards`` (optional; ``distributed/sharding.py::ModelShards``,
    set by the tensor-parallel builders) says which parameters a rank of
    a model axis larger than 1 holds a block of, and which factor rows
    (``ModelShards.factor_rows``: the reference's ``kfac_state_sharding``
    puts U and M rows on "model" where the axis divides d).  A rank then
    holds its row block of every such factor (:meth:`init`) and runs the
    factor work on it (``core/kfactor.py``'s row blocks; X whole or its
    rows, :meth:`_stats_factors`).  A sharded tapped leaf's gradient is
    never gathered: where its sharded dimension is one factor's rows
    (a column-parallel tap's G, a row-parallel tap's A), the step is made
    on those rows with one panel summed over the axis per bucket and the
    other side's U gathered whole (``core/precond.py``'s row blocks); a
    replicated or expert-stacked tap gathers both U's transiently
    (:meth:`_precondition_shards`).  The AdamW fallback updates each
    rank's block, and the clip's global norm counts a sharded leaf's
    blocks once each."""

    def __init__(self, cfg: KfacConfig, taps: Dict[str, TapInfo],
                 device=None, curvature=None):
        self.device = device_lib.resolve(device)
        self.cfg = cfg
        self.curvature = curvature
        self.model_shards = None
        self.taps = dict(taps)
        self.specs = {
            name: dict(A=policy.make_factor_spec(cfg.policy, t.d_in,
                                                 t.n_stat),
                       G=policy.make_factor_spec(cfg.policy, t.d_out,
                                                 t.n_stat))
            for name, t in self.taps.items()}
        self._fallback = _adamw.adamw(cfg.fallback_lr,
                                      weight_decay=cfg.fallback_wd)
        stacks = {n: t.stack for n, t in self.taps.items()}
        lin = {n: t.linear_apply for n, t in self.taps.items()}
        self.factor_buckets = buckets.build_factor_buckets(self.specs, stacks)
        self.precond_buckets = buckets.build_precond_buckets(self.specs,
                                                             stacks, lin)
        # (name, side) → (bucket index, slot offset, slot count): the
        # per-tap path reads its heavy flag and its draws from the same
        # bucket-indexed StepWork and draws the bucketed path consumes
        self._slot = {(e.name, e.side): (bi, e.offset, e.count)
                      for bi, b in enumerate(self.factor_buckets)
                      for e in b.entries}
        # async pipeline: bucket index → interim light panels it replays
        # at landing, for the buckets that carry an in-flight buffer
        self._async_buckets: Dict[int, int] = {
            bi: schedule.n_replay_panels(cfg, b.spec)
            for bi, b in enumerate(self.factor_buckets)
            if schedule.bucket_is_async(cfg, b.spec)}
        if self._async_buckets and not cfg.bucketed:
            raise ValueError("async_heavy requires bucketed=True (the "
                             "in-flight buffers live in bucket layout)")
        self._cycle = self.scheduler().cycle

    def _factor_rows(self, spec):
        """The row block this rank holds of a factor of ``spec`` (None:
        whole, also without model shards)."""
        if self.model_shards is None or spec.width <= 1:
            return None
        return self.model_shards.factor_rows(spec.d)

    def _m_rows(self, spec):
        """The row block of a dense M: the factor's rows on "model",
        unless a curvature engine keeps M's rows on a row axis of its
        own (it then gathers and slices them itself)."""
        if not spec.needs_m or getattr(self.curvature, "row_axis", None):
            return None
        return self._factor_rows(spec)

    def probe_blocks(self) -> Tuple[str, ...]:
        """Taps whose probe gradient a tensor-parallel step may leave as
        the rank's block (``train/loop.py::kfac_grads(keep_blocks=)``):
        the column-parallel ones whose G factor the rank holds by rows and
        feeds no dense M (the block is exactly its rows of X_G)."""
        ms = self.model_shards
        if ms is None:
            return ()
        return tuple(
            n for n, t in self.taps.items()
            if ms.probe_dim(n) == -1 and not t.linear_apply
            and self._factor_rows(self.specs[n]["G"]) is not None
            and not self.specs[n]["G"].needs_m)

    def scheduler(self, **kw) -> schedule.Scheduler:
        """A work scheduler over this optimizer's factor buckets; with a
        curvature engine attached, heavy chunks align to its ``align``
        (slot-axis size × row-axis size) unless ``align`` is given."""
        if "align" not in kw and self.curvature is not None:
            kw["align"] = getattr(self.curvature, "align",
                                  self.curvature.n_devices)
        return schedule.Scheduler(self.cfg, self.factor_buckets, **kw)

    def uniform_work(self, do_stats: bool, do_light: bool, do_heavy: bool
                     ) -> schedule.StepWork:
        return schedule.uniform_work(do_stats, do_light, do_heavy,
                                     self.factor_buckets)

    def remedial_work(self) -> schedule.StepWork:
        """The forced-refresh mask of the remediation ladder (stage 2):
        full-range inline heavy + stats/light absorb, out of cadence —
        see :func:`repro_torch.core.schedule.remedial_work`."""
        return schedule.remedial_work(self.cfg, self.factor_buckets)

    def clear_inflight(self, state: KfacState) -> KfacState:
        """Invalidate every in-flight snapshot: each still-scheduled
        landing becomes a per-slot no-op."""
        return dataclasses.replace(state, inflight={
            k: dataclasses.replace(buf, live=torch.zeros_like(buf.live))
            for k, buf in state.inflight.items()})

    # -- state ------------------------------------------------------------
    def init(self, params: Params) -> KfacState:
        device = self.device
        wrong = [k for k, p in params.items() if p.device.type != device.type]
        if wrong:
            raise ValueError(f"parameters {wrong[:3]} are not on {device}")
        factors = {}
        for name, t in self.taps.items():
            def stacked(spec):
                rows, m_rows = self._factor_rows(spec), self._m_rows(spec)
                st = kfactor.make_state(
                    spec.d, spec.width, spec.needs_m, device=device,
                    rows=rows and rows.rb, m_rows=m_rows and m_rows.rb)
                return st.map(lambda x: x.expand(tuple(t.stack) + x.shape)
                              .clone())
            factors[name] = TapState(A=stacked(self.specs[name]["A"]),
                                     G=stacked(self.specs[name]["G"]))
        mom = None
        if self.cfg.momentum > 0:
            mom = {n: torch.zeros_like(params[t.param_path],
                                       dtype=torch.float32)
                   for n, t in self.taps.items()}
        fb = self._fallback.init(self._untapped(params))
        inflight = {str(bi): kfactor.make_inflight(
                        self.factor_buckets[bi].spec,
                        self.factor_buckets[bi].total, n_replay,
                        device=device)
                    for bi, n_replay in self._async_buckets.items()}
        state = KfacState(step=0, n_stats=0, phase=0, factors=factors,
                          momentum=mom, fallback=fb, inflight=inflight)
        if self.curvature is not None:
            state = self.curvature.localize_state(self, state)
        return state

    def _untapped(self, tree: Params) -> Params:
        paths = {t.param_path for t in self.taps.values()}
        return {k: v for k, v in tree.items() if k not in paths}

    # -- factor work --------------------------------------------------------
    def _stats_factors(self, name, acts, probe_grads, n_tokens):
        """(X_A, X_G): K-factor square roots, (*stack, d, n_stat); for a
        factor this rank holds by rows, its rows of X unless a dense M
        needs X whole for the absorb (a kept probe block is its rows
        already, ``probe_blocks``)."""
        a = acts[name]
        g = probe_grads[name]
        scale = 1.0 / math.sqrt(a.shape[-2])
        X_A = a.transpose(-1, -2).to(torch.float32) * scale
        # probe grads are w.r.t. the *mean* loss: rescale to per-token
        # sum-loss grads (Martens–Grosse)
        X_G = g.transpose(-1, -2).to(torch.float32) * (float(n_tokens)
                                                        * scale)
        if self.model_shards is None:
            return X_A, X_G
        out = []
        for side, X in (("A", X_A), ("G", X_G)):
            spec = self.specs[name][side]
            rows = self._factor_rows(spec)
            if rows is not None and not spec.needs_m:
                X = rows.local(X)
            out.append(X)
        return tuple(out)

    def _tap_factor_work(self, factors, acts, probe_grads, n_tokens,
                         rng: Optional[torch.Generator], first: bool,
                         work: schedule.StepWork, draws=None):
        """Per-tap factor updates (the comparison path): each tap's stack
        is flattened into a batch and stepped through the same per-bucket
        program as the bucketed path, one call per tap and side.  The
        heavy flag and the injected draws are the tap's slot range of its
        bucket's."""
        factors = dict(factors)
        for name in sorted(self.taps):
            X = dict(zip("AG", self._stats_factors(name, acts, probe_grads,
                                                   n_tokens)))
            new = {}
            for side in ("A", "G"):
                spec = self.specs[name][side]
                bi, off, count = self._slot[(name, side)]
                heavy = work.entry_heavy(bi, off, count)
                st = getattr(factors[name], side)
                stack = self.taps[name].stack
                flat = st.map(lambda x: x.reshape((count,)
                                                  + x.shape[len(stack):]))
                Xf = X[side].reshape((count,) + X[side].shape[len(stack):])
                tdraws = None
                if heavy and kfactor.needs_draws(spec):
                    bdraws = (draws or {}).get(bi)
                    tdraws = (kfactor.draw_heavy(spec, count, rng, Xf.device)
                              if bdraws is None
                              else bdraws[off:off + count].to(Xf.device))
                flat = kfactor.bucket_factor_step(
                    spec, flat, Xf, first, work.stats, work.light,
                    ((0, count),) if heavy else (), self.cfg.use_kernels,
                    draws=tdraws, rows=self._factor_rows(spec),
                    m_rows=self._m_rows(spec))
                new[side] = flat.map(lambda x: x.reshape(
                    tuple(stack) + x.shape[1:]))
            factors[name] = TapState(A=new["A"], G=new["G"])
        return factors

    def _bucketed_factor_work(self, factors, inflight, acts, probe_grads,
                              n_tokens, rng: Optional[torch.Generator],
                              first: bool, work: schedule.StepWork,
                              draws=None, landing=None, phi=None,
                              layout=BucketLayout, bucket_step=None):
        """Stats absorbs, Brand updates and the scheduled heavy ranges as
        one batched call per shape-class bucket; async buckets also run
        this step's pipeline phases (panel ring, launch, land) against
        their in-flight buffer (reference ``core/kfac.py:383``).
        ``draws`` optionally maps bucket index → the heavy op's random
        inputs for all of the bucket's slots (the parity tests inject the
        reference's); otherwise each bucket that fires a heavy range or
        launches one takes one draw from ``rng``, in bucket order — the
        same draws a synchronous step takes.  ``landing`` optionally maps
        bucket index (str) → one pre-computed (U, D, aux) per land range.
        ``phi`` (the step's damping ratio) only feeds telemetry.
        ``layout`` lays each bucket's batch out of the per-tap leaves (the
        tenant bank and the curvature engine pass their own).
        ``bucket_step(bi, bucket, st, X, draws, buf, landed) -> (st,
        buf)`` replaces the inner per-bucket program (the curvature engine
        substitutes its sharded one); the loop around it exists only here,
        so the sharded path cannot diverge from the replicated one
        structurally.  Returns (factors, inflight)."""
        if bucket_step is None:
            def bucket_step(bi, bucket, st, X, bdraws, buf, landed):
                launch = work.launch[bi] if work.launch else ()
                land = work.land[bi] if work.land else ()
                return kfactor.bucket_factor_step_async(
                    bucket.spec, st, X, first, work.stats, work.light,
                    layout.ranges(work.heavy[bi]), launch, land, buf,
                    self.cfg.use_kernels, draws=bdraws, landed=landed,
                    rows=self._factor_rows(bucket.spec),
                    m_rows=self._m_rows(bucket.spec))
        inflight = dict(inflight)
        states, X_all = {}, {}
        for name in sorted(self.taps):
            X_all[(name, "A")], X_all[(name, "G")] = self._stats_factors(
                name, acts, probe_grads, n_tokens)
            states[(name, "A")] = factors[name].A
            states[(name, "G")] = factors[name].G
        # a caller that hands over its only reference to the old states
        # (the tenant bank) frees each bucket's as its new one lands
        del factors
        for bi, bucket in enumerate(self.factor_buckets):
            heavy = layout.ranges(work.heavy[bi])
            launch = work.launch[bi] if work.launch else ()
            land = work.land[bi] if work.land else ()
            if not kfactor.has_work(bucket.spec, work.stats, work.light,
                                    bool(heavy or launch or land)):
                continue
            st = layout.gather_states(bucket.entries, states)
            X = layout.gather(bucket.entries, X_all)
            bdraws = None
            if (heavy or launch) and kfactor.needs_draws(bucket.spec):
                bdraws = (draws or {}).get(bi)
                if bdraws is None:
                    bdraws = kfactor.draw_heavy(bucket.spec, X.shape[0],
                                                rng, X.device)
                bdraws = bdraws.to(X.device)
            with obs_trace.span(f"kfac/factor/b{bi}_"
                                f"{bucket.spec.mode.value}"):
                st, buf = bucket_step(
                    bi, bucket, st, X, bdraws, inflight.get(str(bi)),
                    None if landing is None else landing.get(str(bi)))
            if buf is not None:
                inflight[str(bi)] = buf
            self._record_bucket_metrics(bi, bucket, st, work, land, phi)
            states.update(layout.scatter_states(bucket.entries, st,
                                                states))
        return ({name: TapState(A=states[(name, "A")],
                                G=states[(name, "G")])
                 for name in self.taps}, inflight)

    # -- telemetry (repro_torch.obs) -----------------------------------------
    def _record_bucket_metrics(self, bi, bucket, st, work, land, phi):
        """Per-bucket metrics off the post-step bucket state (reference
        ``core/kfac.py:440``).  Every record is a no-op without an active
        collector, and the derived ones are computed only under one."""
        if not obs_metrics.active():
            return
        spec = bucket.spec
        fired = (sum(hi - lo for lo, hi in work.heavy[bi])
                 + sum(hi - lo for lo, hi in land))
        obs_metrics.record(f"bucket{bi}/heavy_slots", float(fired))
        if bi in self._async_buckets:
            obs_metrics.record(f"bucket{bi}/replay_depth",
                               float(self._async_buckets[bi]))
        if not fired:
            return
        if spec.mode is kfactor.Mode.NS:
            obs_metrics.record(f"bucket{bi}/ns_lam",
                               torch.mean(st.aux[..., kfactor.AUX_LAM]))
            obs_metrics.record(f"bucket{bi}/ns_res",
                               torch.max(st.aux[..., kfactor.AUX_RES]))
        if spec.mode in (kfactor.Mode.EVD, kfactor.Mode.RSVD,
                         kfactor.Mode.BRAND_RSVD):
            obs_metrics.record(f"bucket{bi}/trunc_mass",
                               torch.max(st.aux[..., kfactor.AUX_TRUNC]))
        if spec.needs_m and phi is not None:
            obs_metrics.record(f"bucket{bi}/inv_err",
                               self._inv_error_proxy(spec, st, phi, bi))

    def _inv_error_proxy(self, spec, st, phi, bi=None) -> Tensor:
        """Worst-slot ‖((M + λI) X − I)[rows]‖_F / √k over k ≤ 8 strided
        rows (deterministic: rows 0, s, 2s, … with s = d // k), X the held
        inverse representation and λ the damping the preconditioner
        derives (NS: the λ̂ in aux; low-rank: φ·max D plus the
        continuation shift).  Only computed on heavy-firing steps of an
        instrumented run; a curvature engine computes it on its layout."""
        if self.curvature is not None:
            return self.curvature.inv_error_proxy(self, bi, spec, st, phi)
        d = spec.d
        k = min(8, d)
        idx = torch.arange(k, device=st.M.device) * max(1, d // k)
        rows = self._factor_rows(spec)
        if rows is None:
            sq = self._residual_sq(spec, st.M[..., idx, :], idx, st, phi)
            return torch.max(torch.sqrt(sq / k))
        # the probed rows this rank holds, against U gathered whole; the
        # ranks' squares summed
        mine = idx[(idx >= rows.r0) & (idx < rows.r0 + rows.rb)]
        whole = dataclasses.replace(st, U=rows.gather(st.U))
        sq = rows.sum(self._residual_sq(spec, st.M[..., mine - rows.r0, :],
                                        mine, whole, phi))
        return torch.max(torch.sqrt(sq / k))

    def _residual_sq(self, spec, Mrows, idx, st, phi) -> Tensor:
        """Per slot ‖((M + λI) X − I)[idx]‖_F² from the rows ``Mrows`` =
        M[..., idx, :] (see ``_inv_error_proxy``)."""
        d = spec.d
        ek = torch.eye(d, dtype=Mrows.dtype, device=Mrows.device)[idx]
        if spec.mode is kfactor.Mode.NS:
            lam = st.aux[..., kfactor.AUX_LAM]
            Y = (Mrows + lam[..., None, None] * ek) @ st.U
        else:
            D, lam = precond._damped(st.D, phi,
                                     self.cfg.spectrum_continuation)
            Y = precond.apply_inv_right(
                Mrows + lam[..., None, None] * ek, st.U, D, lam)
        R = Y - ek
        return torch.sum(R * R, dim=(-2, -1))

    # -- preconditioning ------------------------------------------------------
    def _precondition(self, name, st: TapState, grad_w: Tensor, phi,
                      g_factor=None, a_factor=None) -> Tensor:
        """Per-tap preconditioned step for W, in W's (…, d_in, d_out)
        layout.  NS sides apply their dense inverse by GEMM; a
        ``linear_apply`` tap steps from its gradient factors (Alg 8) and
        ignores ``grad_w``."""
        use_k = self.cfg.use_kernels
        cont = self.cfg.spectrum_continuation
        dense_g = self.specs[name]["G"].mode is kfactor.Mode.NS
        dense_a = self.specs[name]["A"].mode is kfactor.Mode.NS
        if self.taps[name].linear_apply:
            S = precond.precondition_linear_with_damping(
                g_factor, a_factor, st.G.U, st.G.D, st.A.U, st.A.D, phi,
                continuation=cont, use_kernel=use_k,
                dense_g=dense_g, dense_a=dense_a)
        else:
            J = grad_w.transpose(-1, -2).to(torch.float32)
            S = precond.precondition_with_damping(
                J, st.G.U, st.G.D, st.A.U, st.A.D, phi,
                continuation=cont, use_kernel=use_k,
                dense_g=dense_g, dense_a=dense_a)
        return S.transpose(-1, -2)

    def _tap_precondition(self, factors, grads: Params, acts, probe_grads,
                          phi) -> Dict[str, Tensor]:
        """Per-tap preconditioning (the comparison path)."""
        out = {}
        for name, t in self.taps.items():
            gfac = afac = None
            if t.linear_apply:
                afac = acts[name].transpose(-1, -2).to(torch.float32)
                gfac = probe_grads[name].transpose(-1, -2).to(torch.float32)
            if self.model_shards is not None:
                out.update(self._precondition_shards(
                    [name], factors, grads, acts, probe_grads, phi,
                    swapped=False))
                continue
            out[name] = self._precondition(name, factors[name],
                                           grads[t.param_path], phi,
                                           g_factor=gfac, a_factor=afac)
        return out

    def _bucketed_precondition(self, factors, grads: Params, acts,
                               probe_grads, phi, layout=BucketLayout
                               ) -> Dict[str, Tensor]:
        """Preconditioned steps for every tap, one batched (fused) call per
        (A-spec, G-spec, linear_apply) bucket, in *parameter layout*: the
        inverse factors are symmetric, so Ā⁻¹ gW Γ̄⁻¹ (the two-sided
        application with the factor roles swapped) equals (Γ̄⁻¹ gWᵀ Ā⁻¹)ᵀ
        without a transpose.  Returns {name: S} in the (…, d_in, d_out)
        layout.  ``layout`` as in ``_bucketed_factor_work``."""
        out = {}
        for pbi, bucket in enumerate(self.precond_buckets):
            with obs_trace.span(f"kfac/precond/b{pbi}"):
                out.update(self._precondition_bucket(
                    bucket, factors, grads, acts, probe_grads,
                    layout.per_slot(phi, bucket.total), layout))
        return out

    def _precondition_bucket(self, bucket, factors, grads: Params, acts,
                             probe_grads, phi, layout=BucketLayout
                             ) -> Dict[str, Tensor]:
        """One precondition bucket's steps, {name: S} (see
        ``_bucketed_precondition``)."""
        if self.model_shards is not None:
            return self._precondition_shards(
                [e.name for e in bucket.entries], factors, grads, acts,
                probe_grads, phi, release=lambda paths: layout.release(
                    grads, paths))
        cont = self.cfg.spectrum_continuation
        use_k = self.cfg.use_kernels
        ent = bucket.entries
        # role swap: the positional "g" slot carries the A factor (and vice
        # versa), so the NS dense flags swap with it
        dense_swap_g = bucket.spec_a.mode is kfactor.Mode.NS
        dense_swap_a = bucket.spec_g.mode is kfactor.Mode.NS
        key = lambda e: (e.name, "")
        gather = layout.gather
        U_g = gather(ent, {key(e): factors[e.name].G.U for e in ent})
        D_g = gather(ent, {key(e): factors[e.name].G.D for e in ent})
        U_a = gather(ent, {key(e): factors[e.name].A.U for e in ent})
        D_a = gather(ent, {key(e): factors[e.name].A.D for e in ent})
        if bucket.linear_apply:
            # Alg 8 with roles swapped:  S = (Ā⁻¹ A)(Gᵀ Γ̄⁻¹)
            gfac = gather(ent, {
                key(e): probe_grads[e.name] for e in ent}
                ).transpose(-1, -2).to(torch.float32)       # (B, d_out, n)
            afac = gather(ent, {
                key(e): acts[e.name] for e in ent}
                ).transpose(-1, -2).to(torch.float32)       # (B, d_in, n)
            S = precond.precondition_linear_with_damping(
                afac, gfac, U_a, D_a, U_g, D_g, phi,
                continuation=cont, use_kernel=use_k,
                dense_g=dense_swap_g, dense_a=dense_swap_a)
        else:
            paths = [self.taps[e.name].param_path for e in ent]
            J = gather(ent, {key(e): grads[p] for e, p in zip(ent, paths)}
                       ).to(torch.float32)
            layout.release(grads, paths)
            S = precond.precondition_with_damping(
                J, U_a, D_a, U_g, D_g, phi,
                continuation=cont, use_kernel=use_k,
                dense_g=dense_swap_g, dense_a=dense_swap_a,
                consume=layout.consumes)
        return {name: Se for (name, _), Se in layout.scatter(ent, S).items()}

    def _precond_kind(self, name: str) -> str:
        """How a tensor-parallel step preconditions tap ``name``: "col"
        (on its G rows), "row" (on its A rows) or "whole" (its U's
        gathered; see :meth:`_precondition_shards`)."""
        ms, t = self.model_shards, self.taps[name]
        nd, dim = len(ms.shapes[t.param_path]), ms.dim(t.param_path)
        for kind, side, at in (("col", "G", nd - 1), ("row", "A", nd - 2)):
            spec = self.specs[name][side]
            if not t.linear_apply and dim == at and \
                    spec.mode is not kfactor.Mode.NS and \
                    self._factor_rows(spec) is not None:
                return kind
        return "whole"

    def shard_bytes(self) -> Dict[str, int]:
        """What a rank holds and moves under tensor parallelism, in bytes
        (fp32): ``factors`` held (U, D and M as the rank holds them) and
        ``factors_whole`` (one device's); a step's preconditioning
        traffic as received by a rank: ``u_gathered`` (the U row blocks
        gathered), ``panels`` (the panels summed) and ``grads_gathered``
        (gradients gathered whole: an NS panel side's)."""
        ms = self.model_shards
        out = dict(factors=0, factors_whole=0, u_gathered=0, panels=0,
                   grads_gathered=0)
        part = (ms.size - 1) / ms.size
        for name, t in self.taps.items():
            k = math.prod(t.stack)
            for side in "AG":
                spec = self.specs[name][side]
                rows, mrows = self._factor_rows(spec), self._m_rows(spec)
                m = spec.d if spec.needs_m else 1
                out["factors_whole"] += 4 * k * (
                    spec.d * spec.width + spec.width + m * m)
                out["factors"] += 4 * k * (
                    (rows.rb if rows else spec.d) * spec.width + spec.width
                    + (mrows.rb if mrows else m) * m)
            kind = self._precond_kind(name)
            w = {s: self.specs[name][s].width for s in "AG"}
            d = {"A": t.d_in, "G": t.d_out}
            for side in _GATHERED[kind]:
                if self._factor_rows(self.specs[name][side]) is not None:
                    out["u_gathered"] += int(4 * k * d[side] * w[side] * part)
            if kind != "whole":
                p = "G" if kind == "col" else "A"
                out["panels"] += 4 * k * w[p] * d["A" if p == "G" else "G"]
            elif ms.dim(t.param_path) is not None and not t.linear_apply \
                    and ms.probe_dim(name) != -3:
                out["grads_gathered"] += int(4 * k * t.d_in * t.d_out * part)
        return out

    def _precondition_shards(self, names, factors, grads: Params, acts,
                             probe_grads, phi, release=None,
                             swapped: bool = True) -> Dict[str, Tensor]:
        """Under tensor parallelism: {name: the rank's block of the
        preconditioned step} for taps that share their factor specs (a
        precondition bucket's, or one tap), no sharded gradient gathered.

        * a column-parallel tap (its gradient's columns on "model", the
          G factor by the same rows): S = Γ̄⁻¹ gWᵀ Ā⁻¹ on its G rows, then
          transposed back (the inverse factors are symmetric);
        * a row-parallel tap (gradient rows, A by the same rows): S =
          Ā⁻¹ gW Γ̄⁻¹ on its A rows, the bucketed path's swapped layout;

        each as one panel on the local rows summed over "model" (the
        panels of the call packed into one collective), then the apply
        pass with the other side's U gathered whole (``core/precond.py``'s
        row blocks).  A replicated tap (its gradient whole), an
        expert-stacked one (whole experts; their factors' rows on
        "model"), an Alg-8 tap or one whose panel side is dense (NS)
        gathers its U's (an NS panel side also its gradient) and takes the
        one-device step on its experts, or its block of it.  The U gathers
        of the call are one collective.  The damping and continuation run
        once over the call's taps, as the one-device bucket (``swapped``)
        or tap (not) runs them, so a run's continuation shifts replay in
        the other.  ``release(paths)`` is called once the gradients are
        read."""
        ms = self.model_shards
        cont, use_k = self.cfg.spectrum_continuation, self.cfg.use_kernels
        spec_a, spec_g = self.specs[names[0]]["A"], self.specs[names[0]]["G"]
        dense = {"A": spec_a.mode is kfactor.Mode.NS,
                 "G": spec_g.mode is kfactor.Mode.NS}
        rows = {"A": self._factor_rows(spec_a), "G": self._factor_rows(spec_g)}
        axis_rows = rows["G"] or rows["A"]
        flat = lambda x, core: x.reshape((-1,) + tuple(x.shape[x.dim()
                                                              - core:]))
        cat = lambda xs: xs[0] if len(xs) == 1 else torch.cat(xs, dim=0)
        # damping and continuation over every tap of the call at once
        D = {side: cat([flat(getattr(factors[n], side).D, 1)
                        for n in names]) for side in "AG"}
        lam = {}
        if swapped:
            D["A"], lam["A"], D["G"], lam["G"] = precond._damped_sides(
                D["A"], D["G"], phi, cont, dense["A"], dense["G"])
        else:
            D["G"], lam["G"], D["A"], lam["A"] = precond._damped_sides(
                D["G"], D["A"], phi, cont, dense["G"], dense["A"])
        span, off = {}, 0
        for n in names:
            k = math.prod(self.taps[n].stack)
            span[n], off = (off, off + k), off + k
        part = lambda x, n: x if x.dim() == 0 else x[span[n][0]:span[n][1]]
        kinds, pending = {}, []          # pending: (name, side) to gather
        for name in names:
            kinds[name] = kind = self._precond_kind(name)
            pending += [(name, side) for side in _GATHERED[kind]
                        if rows[side] is not None]
        gathered = dict(zip(pending, axis_rows.gather_all(
            [getattr(factors[n], side).U for n, side in pending],
            [-2] * len(pending)) if pending else []))
        U_of = lambda n, side: gathered.get(
            (n, side), getattr(factors[n], side).U)
        out: Dict[str, Tensor] = {}
        panels, shapes = {}, {}
        for kind, p_side, o_side in (("col", "G", "A"), ("row", "A", "G")):
            mine = [n for n in names if kinds[n] == kind]
            if not mine:
                continue
            J = []
            for n in mine:
                g = grads[self.taps[n].param_path]
                shapes[n] = g.shape
                J.append(flat(g.transpose(-1, -2) if kind == "col" else g,
                              2).to(torch.float32))
            J = cat(J)
            U_p = cat([flat(getattr(factors[n], p_side).U, 2) for n in mine])
            U_o = cat([flat(U_of(n, o_side), 2) for n in mine])
            sides = [cat([part(x, n) for n in mine]) for x in (
                D[p_side], lam[p_side], D[o_side], lam[o_side])]
            Cg = precond.rows_panel(J, U_p, precond.lowrank_inv_diag(
                sides[0], sides[1]), use_k)
            panels[kind] = (mine, J, U_p, Cg, U_o, sides, dense[o_side])
        if release is not None:      # J holds what the steps still read
            release([self.taps[n].param_path for n in shapes])
        if panels:
            axis_rows.sum_all([v[3] for v in panels.values()])
        for kind in list(panels):
            mine, J, U_p, Cg, U_o, sides, dense_o = panels.pop(kind)
            S = precond.rows_apply(J, U_p, Cg, U_o, sides[2], sides[1],
                                   sides[3], use_k, dense_o)
            del J, Cg
            off = 0
            for n in mine:
                k = math.prod(shapes[n][:-2])
                Sn = S[off:off + k]
                off += k
                if kind == "col":
                    Sn = Sn.transpose(-1, -2)
                out[n] = Sn.reshape(shapes[n])
        for n in [n for n in names if kinds[n] == "whole"]:
            stack = tuple(self.taps[n].stack)
            side = lambda s: (U_of(n, s),
                              part(D[s], n).reshape(stack + (-1,)),
                              part(lam[s], n).reshape(
                                  stack if lam[s].dim() else ()))
            out[n] = self._precondition_whole(n, side("G"), side("A"),
                                              dense, grads, acts,
                                              probe_grads)
        if release is not None:
            release([self.taps[n].param_path for n in names
                     if n not in shapes])
        return out

    def _precondition_whole(self, name, g, a, dense, grads, acts,
                            probe_grads) -> Tensor:
        """One tap's step from its sides whole, ``g``/``a`` = (U gathered,
        damped D, λ) each: the one-device step on its gradient as the rank
        holds it — whole (a replicated tap), its experts (their sides
        taken likewise), or its block of the step on the gradient gathered
        whole (an Alg-8 tap's from its factors, an NS panel side's)."""
        ms, t = self.model_shards, self.taps[name]
        path = t.param_path
        nd, dim = len(ms.shapes[path]), ms.dim(path)
        grad = grads.get(path)
        if dim is not None and dim == nd - 3 and not t.linear_apply:
            # an expert stack: the rank's experts of every side (the last
            # stack dimension)
            e = len(t.stack) - 1
            size = t.stack[e] // ms.size
            ex = lambda x: x if x.dim() <= e else x.narrow(
                e, ms.index * size, size)
            g, a = tuple(map(ex, g)), tuple(map(ex, a))
            dim = None
        elif dim is not None and not t.linear_apply:
            grad = ms.gather(path, grad)
        if t.linear_apply:
            afac = acts[name].transpose(-1, -2).to(torch.float32)
            gfac = probe_grads[name].transpose(-1, -2).to(torch.float32)
            S = precond.kfac_precondition_linear(
                afac, gfac, *a, *g, self.cfg.use_kernels,
                dense_g=dense["A"], dense_a=dense["G"])
        else:
            S = precond.kfac_precondition(
                grad.to(torch.float32), *a, *g, self.cfg.use_kernels,
                dense_g=dense["A"], dense_a=dense["G"])
        return S if dim is None else ms.block(path, S)

    # -- the update ---------------------------------------------------------
    def update(self, grads: Params, state: KfacState, params: Params, *,
               acts, probe_grads, n_tokens: int,
               rng: Optional[torch.Generator],
               work: schedule.StepWork, draws=None, landing=None,
               damping_scale=None, consume_grads: bool = False
               ) -> Tuple[Params, KfacState]:
        """One optimizer step → (updates, new state).  ``work`` is the
        step's StepWork mask; ``draws`` optionally injects the heavy ops'
        random inputs per bucket (see ``_bucketed_factor_work``);
        ``landing`` optionally carries pre-computed heavy results for
        this step's land ranges (bucket idx str → one (U, D, aux) or
        None per range, from ``train.loop.AsyncInverseRunner``); absent,
        landings compute here from the in-flight snapshot.

        ``damping_scale`` (optional float) multiplies the scheduled
        damping ratio φ — the remediation ladder's stage-1 knob
        (train/health.py); a scale of exactly 1.0 changes no bit.  The
        state passed in is never modified: a caller may keep it and
        discard the new one.

        ``consume_grads`` hands ``grads`` over, and the AdamW fallback's
        moments of ``state`` with them: on the bucketed path each tapped
        gradient leaves the dict once its bucket is gathered, so the
        update does not hold the gradients beside their preconditioned
        steps (gigabytes at a full-width LM), and an untapped parameter's
        update is made in its gradient's storage, its new moments in the
        old ones' (``AdamW.update(consume=True)``), so ``state`` is not to
        be used again; the numbers are the same."""
        cfg = self.cfg
        first = state.n_stats == 0
        phi = cfg.damping_phi(state.step)
        if damping_scale is not None:
            phi = phi * float(damping_scale)
        lr = cfg.lr(state.step)
        if obs_metrics.active():
            slots = lambda t: float(sum(hi - lo for r in t
                                        for lo, hi in r))
            obs_metrics.record("work/stats_fired",
                               1.0 if work.stats else 0.0)
            obs_metrics.record("work/light_fired",
                               1.0 if work.light else 0.0)
            obs_metrics.record("work/heavy_slots", slots(work.heavy))
            obs_metrics.record("work/launch_slots", slots(work.launch))
            obs_metrics.record("work/land_slots", slots(work.land))
            obs_metrics.record("precond/damping_phi", phi)

        factors = dict(state.factors)
        inflight = dict(state.inflight)
        shards = state.shards
        if work.any and self.curvature is not None and cfg.bucketed:
            factors, inflight, shards = self.curvature.factor_work(
                self, factors, inflight, shards, acts, probe_grads,
                n_tokens, rng, first, work, draws=draws, landing=landing,
                phi=phi)
        elif work.any and cfg.bucketed:
            factors, inflight = self._bucketed_factor_work(
                factors, inflight, acts, probe_grads, n_tokens, rng, first,
                work, draws=draws, landing=landing, phi=phi)
        elif work.any:
            if work.any_async:
                raise ValueError("async launch/land masks require the "
                                 "bucketed optimizer path")
            factors = self._tap_factor_work(factors, acts, probe_grads,
                                            n_tokens, rng, first, work,
                                            draws=draws)

        order = list(grads)
        untapped = self._untapped(grads)
        if cfg.bucketed:
            S_all = self._bucketed_precondition(
                factors, grads, acts, probe_grads, phi,
                layout=_ConsumedGrads if consume_grads else BucketLayout)
        else:
            S_all = self._tap_precondition(factors, grads, acts,
                                           probe_grads, phi)
        updates: Params = {}
        new_mom = dict(state.momentum) if state.momentum is not None else None
        # each tap's preconditioned step becomes its update in place, and is
        # dropped from S_all as it goes: at billions of parameters the
        # optimizer must not hold two more copies of them (the same
        # operations as out of place, so the same bits)
        ms = self.model_shards
        for name, t in self.taps.items():
            S = S_all.pop(name)
            S.add_(cfg.weight_decay
                   * params[t.param_path].detach().to(torch.float32))
            if new_mom is not None:
                S = new_mom[name] = cfg.momentum * new_mom[name] + S
                updates[t.param_path] = -lr * S
            else:
                updates[t.param_path] = S.mul_(-lr)
        fb_updates, fb_state = self._fallback.update(
            untapped, state.fallback, self._untapped(params),
            consume=consume_grads)
        updates.update(fb_updates)
        updates = {k: updates[k] for k in order}     # parameter order
        if cfg.clip > 0:
            updates = optbase.clip_by_global_norm_(
                updates, cfg.clip,
                norm=None if ms is None else torch.sqrt(ms.sq_norm(updates)))

        new_state = KfacState(
            step=state.step + 1,
            n_stats=state.n_stats + int(work.stats),
            phase=(state.phase + 1) % self._cycle,
            factors=factors, momentum=new_mom, fallback=fb_state,
            inflight=inflight, shards=shards)
        return updates, new_state
