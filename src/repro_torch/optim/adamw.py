"""AdamW — the fallback optimizer for the parameters no K-FAC tap owns
(biases, batch-norm scales).

Counterpart of ``src/repro/optim/adamw.py``.  The reference keeps moments
for the whole parameter tree and masks the result; here the fallback is
built over the untapped parameters only, which gives the same updates
for them without moments for the tapped weights (a 16384×2048 FC0 would
carry 268 MB of unused moments).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from repro_torch.optim.base import Schedule

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass
class AdamWState:
    step: int
    mu: Params
    nu: Params


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Schedule
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0

    def init(self, params: Params) -> AdamWState:
        zeros = {k: torch.zeros_like(p, dtype=torch.float32)
                 for k, p in params.items()}
        return AdamWState(step=0, mu=zeros,
                          nu={k: z.clone() for k, z in zeros.items()})

    def update(self, grads: Params, state: AdamWState, params: Params
               ) -> Tuple[Params, AdamWState]:
        step = state.step + 1
        a = self.lr(state.step)
        c1 = 1.0 - self.b1 ** step
        c2 = 1.0 - self.b2 ** step
        upd, mu, nu = {}, {}, {}
        for k, g in grads.items():
            g = g.to(torch.float32)
            m = self.b1 * state.mu[k] + (1 - self.b1) * g
            v = self.b2 * state.nu[k] + (1 - self.b2) * g * g
            d = (m / c1) / (torch.sqrt(v / c2) + self.eps)
            if self.weight_decay:
                d = d + self.weight_decay * params[k].to(torch.float32)
            upd[k], mu[k], nu[k] = -a * d, m, v
        return upd, AdamWState(step=step, mu=mu, nu=nu)


def adamw(lr: Schedule, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.0) -> AdamW:
    return AdamW(lr=lr, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay)
