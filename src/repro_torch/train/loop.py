"""Training loop: ties a tapped model's loss and the K-FAC optimizer into
scheduled steps.

Counterpart of ``src/repro/train/loop.py``, synchronous part.  One
backward pass (``torch.autograd.grad`` over parameters and probes
together) gives the parameter gradients and the probe gradients — the
backward K-factor square roots.  The reference's distributed, telemetry,
checkpoint and resilience specs and its async runner are later slices.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterable, List, Optional

import torch

from repro_torch import device as device_lib
from repro_torch.core import kfac as kfac_lib
from repro_torch.models import layers
from repro_torch.optim import base as optbase

Tensor = torch.Tensor


@dataclasses.dataclass
class TrainState:
    params: Dict[str, Tensor]
    opt: kfac_lib.KfacState
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
    """Returns step(state, batch, work, draws=None) → (state, loss), with
    ``work`` the step's StepWork mask.  Parameters are updated in place."""

    def step(state: TrainState, batch, work, draws=None):
        dev = next(iter(state.params.values())).device
        probes = layers.make_probes(opt.taps, device=dev, dtype=probe_dtype)
        loss, acts, gp, gprobe = kfac_grads(loss_fn, state.params, probes,
                                            batch)
        updates, opt_state = opt.update(
            gp, state.opt, state.params, acts=acts, probe_grads=gprobe,
            n_tokens=n_tokens, rng=state.rng, work=work, draws=draws)
        optbase.apply_updates(state.params, updates)
        return dataclasses.replace(state, opt=opt_state), loss

    return step


def run_kfac_training(loss_fn, opt: kfac_lib.Kfac, params: Dict[str, Tensor],
                      batches: Iterable, n_tokens: int, seed: int = 0,
                      callback=None, device=None,
                      draws: Optional[Callable[[int], Dict]] = None):
    """Drive the scheduled steps over ``batches`` (the work scheduler picks
    each step's mask; ``cfg.stagger`` phases heavy work).  ``device=None``
    means the card, and a host without one raises; the parameters must
    already live on the device.  ``draws(step)`` optionally injects the
    heavy ops' random inputs per bucket (parity tests); otherwise they
    come from a generator seeded with ``seed``.  Returns (final
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
    losses: List[Tensor] = []
    for k, batch in enumerate(batches):
        state, loss = step_fn(state, batch, sched.work(k),
                              draws=None if draws is None else draws(k))
        losses.append(loss)
        if callback is not None:
            callback(k, state, loss)
    return state, [float(x) for x in losses]
