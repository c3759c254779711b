"""Stable public API surface of the port.

Counterpart of ``src/repro/api.py``: every name of the reference's
``__all__`` that the port has, from the same places::

    from repro_torch import api

    opt = api.Kfac(api.KfacConfig(...), taps)          # on the card
    state, losses = api.run_kfac_training(
        loss_fn, opt, params, batches, n_tokens=...,
        obs=api.ObsSpec(writer=api.TelemetryWriter("events.jsonl")),
        ckpt=api.CkptSpec(dir="ckpt"),
        resilience=api.ResilienceSpec(health=True))

Every name of the reference's ``__all__`` is here; :data:`NOT_YET_PORTED`
is empty.
"""
from __future__ import annotations

# optimizer core
from repro_torch.core.kfac import Kfac, KfacConfig, KfacState, TapInfo
from repro_torch.core.policy import PolicyConfig
from repro_torch.core.schedule import Scheduler, StepWork, group_by_work

# typed option specs
from repro_torch.specs import CkptSpec, DistSpec, ObsSpec, ResilienceSpec

# training entry points
from repro_torch.train.loop import (kfac_grads, make_scheduled_kfac_step,
                                    run_kfac_training)

# multi-tenant bank + serving
from repro_torch.core.tenant import TenantBank, tree_stack, tree_unstack
from repro_torch.serve.engine import Engine, Request
from repro_torch.serve.service import FinetuneRequest, TenantService

# launch tooling
from repro_torch.launch.steps import build_train_step, default_kfac_config

# observability
from repro_torch.obs import TelemetryWriter

#: the reference's ``__all__`` names this package does not have yet
NOT_YET_PORTED = ()

__all__ = [
    # optimizer
    "Kfac", "KfacConfig", "KfacState", "PolicyConfig", "TapInfo",
    "Scheduler", "StepWork", "group_by_work",
    # specs
    "DistSpec", "ObsSpec", "CkptSpec", "ResilienceSpec",
    # training
    "run_kfac_training", "make_scheduled_kfac_step", "kfac_grads",
    # multi-tenant + serving
    "TenantBank", "tree_stack", "tree_unstack",
    "TenantService", "FinetuneRequest", "Engine", "Request",
    # launch tooling
    "build_train_step", "default_kfac_config",
    # observability
    "TelemetryWriter",
]
