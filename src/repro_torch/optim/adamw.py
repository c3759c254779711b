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

#: entries a leaf's step computes at once (64 Mi: 256 MB a temporary)
_CHUNK = 1 << 26


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

    def update(self, grads: Params, state: AdamWState, params: Params,
               consume: bool = False) -> Tuple[Params, AdamWState]:
        """``consume``: the caller owns ``grads`` and ``state`` and drops
        them — each update is made in its gradient's storage and the new
        moments in the old ones' (the same numbers, without three
        temporaries of each leaf's size: a gemma3-4b embedding is 2.7 GB).
        A leaf whose tensors cannot take it (not fp32 and contiguous) is
        stepped out of place."""
        upd, mu, nu = {}, {}, {}
        for k, g in grads.items():
            args = (g, state.mu[k], state.nu[k], params[k], state.step)
            if consume and all(x.dtype == torch.float32
                               and x.is_contiguous() for x in args[:3]):
                upd[k], mu[k], nu[k] = self.leaf(*args, out=args[:3])
            else:
                upd[k], mu[k], nu[k] = self.leaf(*args)
        return upd, AdamWState(step=state.step + 1, mu=mu, nu=nu)

    def leaf(self, g, mu, nu, p, step: int, out=None):
        """One parameter's step at the state's ``step`` → (update, new
        first moment, new second moment); the multi-tenant bank calls it
        for each tenant's slice with that tenant's step.

        Every operation is elementwise, so a large leaf (or one given
        ``out``: the update's, m's and v's destinations, which may be
        ``g``, ``mu`` and ``nu`` themselves) is computed in row chunks
        (the same numbers): its temporaries then cost a chunk, not the
        leaf."""
        if g.dim() == 0 or (out is None and g.numel() <= _CHUNK):
            res = self._leaf(g, mu, nu, p, step)
            if out is None:
                return res
            for o, x in zip(out, res):
                o.copy_(x)
            return tuple(out)
        if out is None:
            out = [torch.empty(g.shape, dtype=torch.float32,
                               device=g.device) for _ in range(3)]
        rows = max(1, _CHUNK // max(1, g[0].numel()))
        with torch.no_grad():
            for r0 in range(0, g.shape[0], rows):
                r = slice(r0, r0 + rows)
                for o, x in zip(out, self._leaf(g[r], mu[r], nu[r], p[r],
                                                step)):
                    o[r] = x
        return tuple(out)

    def _leaf(self, g, mu, nu, p, step: int):
        a = self.lr(step)
        c1 = 1.0 - self.b1 ** (step + 1)
        c2 = 1.0 - self.b2 ** (step + 1)
        g = g.to(torch.float32)
        m = self.b1 * mu + (1 - self.b1) * g
        v = self.b2 * nu + (1 - self.b2) * g * g
        d = (m / c1) / (torch.sqrt(v / c2) + self.eps)
        if self.weight_decay:
            d = d + self.weight_decay * p.to(torch.float32)
        return -a * d, m, v


def adamw(lr: Schedule, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.0) -> AdamW:
    return AdamW(lr=lr, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay)
