"""SGD with momentum and weight decay (a baseline of the paper's §6).

Counterpart of ``src/repro/optim/sgd.py``: the weight decay is added to
the gradient, the momentum buffer is fp32, and ``nesterov`` steps along
g + μ·m.  The step counter lives on the host, as in ``optim/base.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from repro_torch.optim.base import Schedule

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass
class SgdState:
    step: int
    momentum: Params


@dataclasses.dataclass(frozen=True)
class Sgd:
    lr: Schedule
    momentum: float = 0.9
    weight_decay: float = 0.0
    nesterov: bool = False

    def init(self, params: Params) -> SgdState:
        return SgdState(step=0, momentum={
            k: torch.zeros_like(p, dtype=torch.float32)
            for k, p in params.items()})

    def update(self, grads: Params, state: SgdState, params: Params, **_
               ) -> Tuple[Params, SgdState]:
        a = self.lr(state.step)
        upd, mom = {}, {}
        for k, g in grads.items():
            g = (g.to(torch.float32)
                 + self.weight_decay * params[k].to(torch.float32))
            m = self.momentum * state.momentum[k] + g
            d = g + self.momentum * m if self.nesterov else m
            upd[k], mom[k] = -a * d, m
        return upd, SgdState(step=state.step + 1, momentum=mom)


def sgd(lr: Schedule, momentum: float = 0.9, weight_decay: float = 0.0,
        nesterov: bool = False) -> Sgd:
    return Sgd(lr=lr, momentum=momentum, weight_decay=weight_decay,
               nesterov=nesterov)
