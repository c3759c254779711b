"""Schedules, clipping and update application shared by the optimizers.

Counterpart of ``src/repro/optim/base.py``.  Schedules map a step (a
Python int — the port keeps step counters on the host) to a Python float,
so reading the learning rate or the damping never waits on the card.
``updates`` are additive deltas, already scaled by −lr.
"""
from __future__ import annotations

import bisect
from typing import Callable, Dict, Optional, Sequence

import torch

Schedule = Callable[[int], float]


def constant(v: float) -> Schedule:
    return lambda step: float(v)


def piecewise(boundaries: Sequence[float], values: Sequence[float]
              ) -> Schedule:
    """Paper-style staircase: values[i] for the i-th interval, where a step
    equal to a boundary already takes the next value."""
    bs = [float(b) for b in boundaries]
    vs = [float(v) for v in values]
    return lambda step: vs[bisect.bisect_right(bs, float(step))]


def paper_lr_schedule(steps_per_epoch: int) -> Schedule:
    """α_k = 0.3 − 0.1·[e≥2] − 0.1·[e≥3] − 0.07·[e≥13] − 0.02·[e≥18]
                − 0.007·[e≥27] − 0.002·[e≥40]   (paper §6)."""
    e = steps_per_epoch
    vals = [0.3, 0.2, 0.1, 0.03, 0.01, 0.003, 0.001]
    return piecewise([2 * e, 3 * e, 13 * e, 18 * e, 27 * e, 40 * e], vals)


def paper_damping_schedule(steps_per_epoch: int) -> Schedule:
    """φ_λ,k = 0.1 − 0.05·[e≥25] − 0.04·[e≥35]   (paper §6)."""
    e = steps_per_epoch
    return piecewise([25 * e, 35 * e], [0.1, 0.05, 0.01])


def global_norm(tree: Dict[str, torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in tree.values()))


def clip_by_global_norm(tree: Dict[str, torch.Tensor], max_norm: float
                        ) -> Dict[str, torch.Tensor]:
    """Scale the whole update so its global l2 norm ≤ max_norm (the
    paper's clip on the preconditioned step).  The scale stays a device
    tensor: no host sync."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / (norm + 1e-12), max=1.0)
    return {k: (x * scale).to(x.dtype) for k, x in tree.items()}


def clip_by_global_norm_(tree: Dict[str, torch.Tensor], max_norm: float,
                         norm: Optional[torch.Tensor] = None
                         ) -> Dict[str, torch.Tensor]:
    """``clip_by_global_norm`` that scales every tensor of ``tree`` in
    place and returns it: the same bits, without a second copy of an
    update of billions of parameters.  For a caller that owns the
    tensors.  ``norm`` replaces the tree's own global norm (a tensor-
    parallel tree's, over every rank's blocks)."""
    if norm is None:
        norm = global_norm(tree)
    scale = torch.clamp(max_norm / (norm + 1e-12), max=1.0)
    for x in tree.values():
        x.mul_(scale)
    return tree


@torch.no_grad()
def apply_updates(params: Dict[str, torch.Tensor],
                  updates: Dict[str, torch.Tensor]) -> None:
    """params += updates, in place (the parameters are the model's own
    tensors, so the model moves with them)."""
    for k, p in params.items():
        p.add_(updates[k].to(p.dtype))
