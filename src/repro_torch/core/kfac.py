"""The K-FAC optimizer family (K-FAC / R-KFAC / B-KFAC / B-R-KFAC /
B-KFAC-C) as one policy-driven optimizer, bucketed and synchronous.

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

Not ported in this slice (they raise): the per-tap comparison path
(``bucketed=False``), the async heavy pipeline, the distributed curvature
engine, NS-KFAC; the telemetry hooks are left out (the reference's are
no-ops with no collector active).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch import device as device_lib
from repro_torch.core import buckets, kfactor, policy, precond, schedule
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
    linear_apply: bool = False      # Alg 8 (a later slice)


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


class Kfac:
    """K-FAC optimizer over a tapped model (holds statics only).
    ``device=None`` means the card; its state lives there."""

    def __init__(self, cfg: KfacConfig, taps: Dict[str, TapInfo],
                 device=None):
        if not cfg.bucketed:
            raise NotImplementedError(
                "bucketed=False (the per-tap comparison path) is not ported")
        if cfg.async_heavy:
            raise NotImplementedError(
                "async_heavy is not ported yet: see ROADMAP.md, the async "
                "pipeline slice")
        if cfg.policy.variant == "nskfac":
            raise NotImplementedError(kfactor._NS_TODO)
        if any(t.linear_apply for t in taps.values()):
            raise NotImplementedError(
                "linear_apply taps (Alg 8) are not ported yet: see "
                "ROADMAP.md, the lowrank_apply slice")
        self.device = device_lib.resolve(device)
        self.cfg = cfg
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
        self._cycle = self.scheduler().cycle

    def scheduler(self, **kw) -> schedule.Scheduler:
        return schedule.Scheduler(self.cfg, self.factor_buckets, **kw)

    def uniform_work(self, do_stats: bool, do_light: bool, do_heavy: bool
                     ) -> schedule.StepWork:
        return schedule.uniform_work(do_stats, do_light, do_heavy,
                                     self.factor_buckets)

    # -- state ------------------------------------------------------------
    def init(self, params: Params) -> KfacState:
        device = self.device
        wrong = [k for k, p in params.items() if p.device.type != device.type]
        if wrong:
            raise ValueError(f"parameters {wrong[:3]} are not on {device}")
        factors = {}
        for name, t in self.taps.items():
            def stacked(spec):
                st = spec.init(device=device)
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
        return KfacState(step=0, n_stats=0, phase=0, factors=factors,
                         momentum=mom, fallback=fb)

    def _untapped(self, tree: Params) -> Params:
        paths = {t.param_path for t in self.taps.values()}
        return {k: v for k, v in tree.items() if k not in paths}

    # -- factor work --------------------------------------------------------
    def _stats_factors(self, name, acts, probe_grads, n_tokens):
        """(X_A, X_G): K-factor square roots, (*stack, d, n_stat)."""
        a = acts[name]
        g = probe_grads[name]
        scale = 1.0 / math.sqrt(a.shape[-2])
        X_A = a.transpose(-1, -2).to(torch.float32) * scale
        # probe grads are w.r.t. the *mean* loss: rescale to per-token
        # sum-loss grads (Martens–Grosse)
        X_G = g.transpose(-1, -2).to(torch.float32) * (float(n_tokens)
                                                        * scale)
        return X_A, X_G

    def _bucketed_factor_work(self, factors, acts, probe_grads, n_tokens,
                              rng: Optional[torch.Generator], first: bool,
                              work: schedule.StepWork, draws=None):
        """Stats absorbs, Brand updates and the scheduled heavy ranges as
        one batched call per shape-class bucket.  ``draws`` optionally maps
        bucket index → the heavy op's random inputs for all of the
        bucket's slots (the parity tests inject the reference's); otherwise
        each firing bucket takes one draw from ``rng``."""
        states, X_all = {}, {}
        for name in sorted(self.taps):
            X_all[(name, "A")], X_all[(name, "G")] = self._stats_factors(
                name, acts, probe_grads, n_tokens)
            states[(name, "A")] = factors[name].A
            states[(name, "G")] = factors[name].G
        for bi, bucket in enumerate(self.factor_buckets):
            heavy = work.heavy[bi]
            if not kfactor.has_work(bucket.spec, work.stats, work.light,
                                    bool(heavy)):
                continue
            st = buckets.gather_states(bucket.entries, states)
            X = buckets.gather(bucket.entries, X_all)
            bdraws = None
            if heavy and kfactor.needs_draws(bucket.spec):
                bdraws = (draws or {}).get(bi)
                if bdraws is None:
                    bdraws = kfactor.draw_heavy(bucket.spec, bucket.total,
                                                rng, X.device)
                bdraws = bdraws.to(X.device)
            st = kfactor.bucket_factor_step(
                bucket.spec, st, X, first, work.stats, work.light, heavy,
                self.cfg.use_kernels, draws=bdraws)
            states.update(buckets.scatter_states(bucket.entries, st))
        return {name: TapState(A=states[(name, "A")], G=states[(name, "G")])
                for name in self.taps}

    # -- preconditioning ------------------------------------------------------
    def _bucketed_precondition(self, factors, grads: Params, phi: float
                               ) -> Dict[str, Tensor]:
        """Preconditioned steps for every tap, one batched (fused) call per
        (A-spec, G-spec) bucket, in *parameter layout*: the inverse
        factors are symmetric, so Ā⁻¹ gW Γ̄⁻¹ (the two-sided application
        with the factor roles swapped) equals (Γ̄⁻¹ gWᵀ Ā⁻¹)ᵀ without a
        transpose.  Returns {name: S} in the (…, d_in, d_out) layout."""
        out = {}
        for bucket in self.precond_buckets:
            ent = bucket.entries
            key = lambda e: (e.name, "")
            U_g = buckets.gather(ent, {key(e): factors[e.name].G.U
                                       for e in ent})
            D_g = buckets.gather(ent, {key(e): factors[e.name].G.D
                                       for e in ent})
            U_a = buckets.gather(ent, {key(e): factors[e.name].A.U
                                       for e in ent})
            D_a = buckets.gather(ent, {key(e): factors[e.name].A.D
                                       for e in ent})
            J = buckets.gather(ent, {
                key(e): grads[self.taps[e.name].param_path]
                for e in ent}).to(torch.float32)
            # role swap: the "g" slot carries the A factor and vice versa
            S = precond.precondition_with_damping(
                J, U_a, D_a, U_g, D_g, phi,
                continuation=self.cfg.spectrum_continuation,
                use_kernel=self.cfg.use_kernels)
            out.update({name: Se for (name, _), Se
                        in buckets.scatter(ent, S).items()})
        return out

    # -- the update ---------------------------------------------------------
    def update(self, grads: Params, state: KfacState, params: Params, *,
               acts, probe_grads, n_tokens: int,
               rng: Optional[torch.Generator],
               work: schedule.StepWork, draws=None
               ) -> Tuple[Params, KfacState]:
        """One optimizer step → (updates, new state).  ``work`` is the
        step's StepWork mask; ``draws`` optionally injects the heavy ops'
        random inputs per bucket (see ``_bucketed_factor_work``)."""
        cfg = self.cfg
        first = state.n_stats == 0
        phi = cfg.damping_phi(state.step)
        lr = cfg.lr(state.step)

        factors = dict(state.factors)
        if work.any:
            factors = self._bucketed_factor_work(
                factors, acts, probe_grads, n_tokens, rng, first, work,
                draws=draws)

        S_all = self._bucketed_precondition(factors, grads, phi)
        updates: Params = {}
        new_mom = dict(state.momentum) if state.momentum is not None else None
        for name, t in self.taps.items():
            S = S_all[name] + cfg.weight_decay * params[t.param_path].to(
                torch.float32)
            if new_mom is not None:
                S = new_mom[name] = cfg.momentum * new_mom[name] + S
            updates[t.param_path] = -lr * S
        fb_updates, fb_state = self._fallback.update(
            self._untapped(grads), state.fallback, self._untapped(params))
        updates.update(fb_updates)
        updates = {k: updates[k] for k in grads}     # parameter order
        if cfg.clip > 0:
            updates = optbase.clip_by_global_norm(updates, cfg.clip)

        new_state = KfacState(
            step=state.step + 1,
            n_stats=state.n_stats + int(work.stats),
            phase=(state.phase + 1) % self._cycle,
            factors=factors, momentum=new_mom, fallback=fb_state)
        return updates, new_state
