"""SENG (Yang et al., 2021, "Sketchy Empirical Natural Gradient"), the
paper's state-of-the-art comparison point (§6).

Counterpart of ``src/repro/optim/seng.py``.  A layer-wise *empirical*
Fisher from per-example gradient factors: for a tapped matmul the
per-example gradient is a_i g_iᵀ, so by Woodbury the solve reduces to an
n×n system built from two small Grams (no P×P matrix):

    (λI + (1/n) Σ vec(dW_i) vec(dW_i)ᵀ)⁻¹ vec(Ḡ)
      = (1/λ) [ Ḡ − A diag(c) Gᵀ ],
    c = (λ n I + K)⁻¹ t,   K = (AᵀA) ⊙ (GᵀG),   t_i = a_iᵀ Ḡ g_i,

with A (d_in, n), G (d_out, n) the tapped activations and probe
gradients.  The factors are refreshed every ``T_fim`` steps; between
refreshes the cached ones precondition fresh gradients.  The reference
computes this in ``jnp`` outside any Pallas kernel; here it is
``torch.matmul`` and ``torch.linalg.solve``, batched over a tap's stack
where the reference ``vmap``s.  The untapped parameters take the port's
AdamW built over them alone, which gives the reference's updates for
them (``optim/adamw.py``).
"""
from __future__ import annotations

import dataclasses
from typing import ClassVar, Dict, Tuple

import torch

from repro_torch import device as device_lib
from repro_torch.core.kfac import TapInfo
from repro_torch.optim import adamw as _adamw
from repro_torch.optim import base as optbase

Tensor = torch.Tensor
Params = Dict[str, Tensor]


@dataclasses.dataclass(frozen=True)
class SengConfig:
    lr: optbase.Schedule = optbase.constant(0.05)
    damping: float = 2.0
    momentum: float = 0.9
    weight_decay: float = 1e-2
    T_fim: int = 200                 # curvature_update_freq
    fallback_lr: optbase.Schedule = optbase.constant(1e-3)

    def flags(self, step: int) -> Dict[str, bool]:
        return dict(do_fim=step % self.T_fim == 0)


@dataclasses.dataclass
class SengState:
    step: int
    factors: Dict[str, Tuple[Tensor, Tensor]]   # name → cached (A, G)
    momentum: Dict[str, Tensor]                 # name → (*stack, d_in, d_out)
    fallback: _adamw.AdamWState
    # keyed by tap name (one checkpoint key each, as in the reference)
    TAP_KEYED: ClassVar[Tuple[str, ...]] = ("factors", "momentum")


def _precondition(A: Tensor, G: Tensor, J: Tensor, lam: float) -> Tensor:
    """Woodbury empirical-NG solve over leading stack axes: A (…, d_in,
    n), G (…, d_out, n), J (…, d_in, d_out) the mean gradient."""
    n = A.shape[-1]
    K = (A.mT @ A) * (G.mT @ G)                        # (…, n, n)
    t = ((A.mT @ J) * G.mT).sum(-1)                    # a_iᵀ J g_i
    eye = torch.eye(n, dtype=J.dtype, device=J.device)
    c = torch.linalg.solve(lam * n * eye + K, t[..., None])
    correction = (A * c.mT) @ G.mT                     # A diag(c) Gᵀ
    return (J - correction) / lam


class Seng:
    """Per-layer sketchy empirical NG over the same tap protocol as
    ``Kfac``.  ``device=None`` means the card."""

    def __init__(self, cfg: SengConfig, taps: Dict[str, TapInfo],
                 device=None):
        self.device = device_lib.resolve(device)
        self.cfg = cfg
        self.taps = dict(taps)
        self._fallback = _adamw.adamw(cfg.fallback_lr)

    def _untapped(self, tree: Params) -> Params:
        paths = {t.param_path for t in self.taps.values()}
        return {k: v for k, v in tree.items() if k not in paths}

    def init(self, params: Params) -> SengState:
        z = lambda *s: torch.zeros(s, dtype=torch.float32,
                                   device=self.device)
        factors = {n: (z(*t.stack, t.d_in, t.n_stat),
                       z(*t.stack, t.d_out, t.n_stat))
                   for n, t in self.taps.items()}
        mom = {n: z(*t.stack, t.d_in, t.d_out) for n, t in self.taps.items()}
        return SengState(step=0, factors=factors, momentum=mom,
                         fallback=self._fallback.init(self._untapped(params)))

    def update(self, grads: Params, state: SengState, params: Params, *,
               acts, probe_grads, n_tokens: int, rng=None,
               do_fim: bool = False) -> Tuple[Params, SengState]:
        cfg = self.cfg
        lr = cfg.lr(state.step)
        factors = dict(state.factors)
        if do_fim:
            for name in self.taps:
                A = acts[name].mT.to(torch.float32)
                G = probe_grads[name].mT.to(torch.float32) * float(n_tokens)
                factors[name] = (A, G)
        updates: Params = {}
        new_mom = dict(state.momentum)
        for name, t in self.taps.items():
            W = params[t.param_path].to(torch.float32)
            J = grads[t.param_path].to(torch.float32)
            S = _precondition(*factors[name], J, cfg.damping)
            m = cfg.momentum * new_mom[name] + (S + cfg.weight_decay * W)
            new_mom[name] = m
            updates[t.param_path] = -lr * m
        fb_updates, fb_state = self._fallback.update(
            self._untapped(grads), state.fallback, self._untapped(params))
        updates.update(fb_updates)
        updates = {k: updates[k] for k in grads}      # parameter order
        return updates, SengState(step=state.step + 1, factors=factors,
                                  momentum=new_mom, fallback=fb_state)
