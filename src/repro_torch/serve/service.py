"""Multi-tenant continuous fine-tuning service.

Counterpart of ``src/repro/serve/service.py``.  One
:class:`~repro_torch.core.tenant.TenantBank` holds N per-tenant parameter
sets and optimizer states, stacked on a leading tenant axis; the service
admits a mixed stream of **fine-tune** requests (a small training batch
against one tenant) and **inference** requests (decode under one tenant's
weights) and batches both across tenants each tick:

* Fine-tune: tenants with a pending batch are grouped by their
  scheduler-derived :class:`~repro_torch.core.schedule.StepWork` mask
  (:func:`repro_torch.core.schedule.group_by_work`: each tenant keeps its
  own schedule position).  For each group, every active tenant's
  gradients come from one ``train.loop.kfac_grads`` over views of its
  slice of the stacked parameters (the reference ``vmap``s the backward;
  the port runs one a tenant), then ONE ``TenantBank.update`` with the
  group's ``active`` mask runs the bucketed factor and preconditioning
  launches for all of them, and the update is added in place.  The
  gradients are dropped before it is.
* Inference: requests ride the engine's per-slot decode lanes; the
  ``lane_params_fn`` hook hands the engine each tenant present in the
  batch as views of its slice, with its lanes — no per-lane copy of the
  weights (``serve/engine.py``).

Checkpoints use the reference's keys and shapes: the stacked {params,
opt} tree (``opt|step``, ``opt|n_stats``, ``opt|phase`` are (N,) arrays)
plus the schema-v6 ``tenants`` table mapping each tenant to its bank slot
and local step, so a restore re-seats every tenant at its own schedule
position (``TenantService.restore``); either package's checkpoint
restores in the other (the port's fallback moments cover the untapped
parameters only: ``train/checkpoint.py``).

Telemetry: ``serve_request`` events (with a ``tenant`` field) for both
request kinds, ``tenant_update`` events per fine-tune step, and
``latency_report()`` p50/p99 over each stream — the numbers the load
generator (serve/load.py) publishes.
"""
from __future__ import annotations

import dataclasses
import queue
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import kfac as kfac_lib
from repro_torch.core import schedule
from repro_torch.core import tenant as tenant_lib
from repro_torch.models import layers
from repro_torch.models.lm import LM
from repro_torch.serve import engine as engine_lib
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train import loop as loop_lib


@dataclasses.dataclass
class FinetuneRequest:
    """One fine-tune step's worth of data for one tenant.  ``batch`` must
    match the service's fixed fine-tune batch shape."""
    uid: int
    tenant: int
    batch: Dict[str, np.ndarray]
    loss: float = float("nan")
    step: int = -1                      # tenant-local step it executed as
    t_submit: float = 0.0
    t_done: float = 0.0


class TenantService:
    """N tenants, one stacked bank, mixed fine-tune/inference traffic.

    ``submit`` takes either an :class:`repro_torch.serve.engine.Request`
    (its ``tenant`` field names the weights to decode under) or a
    :class:`FinetuneRequest`; ``tick()`` advances both streams one step;
    ``run_until_drained()`` loops until all queues are empty.  Runs on
    the optimizer's device; ``base_params`` may be dropped once the
    service is built (it keeps a stacked copy)."""

    def __init__(self, lm: LM, opt: kfac_lib.Kfac, base_params,
                 n_tenants: int, ft_batch: int = 2, ft_seq: int = 16,
                 batch_slots: int = 4, max_len: int = 64,
                 eos_id: Optional[int] = None, seed: int = 0,
                 writer=None, ckpt_dir: Optional[str] = None,
                 ckpt_every: int = 0, ckpt_keep: int = 3):
        self.lm = lm
        self.opt = opt
        self.device = opt.device
        self.n = n_tenants
        self.ft_shape = (ft_batch, ft_seq)
        self.n_tokens = ft_batch * ft_seq
        self.writer = writer
        self.ckpt_dir = ckpt_dir
        self.ckpt_every = ckpt_every
        self.ckpt_keep = ckpt_keep
        self.bank = tenant_lib.TenantBank(opt)
        # every tenant starts from the shared base weights; their slices
        # diverge as fine-tune traffic lands
        self.params = tenant_lib.tree_stack([base_params] * n_tenants)
        self.state = self.bank.init(self.params)
        self.steps: List[int] = [0] * n_tenants   # per-tenant local step
        self.sched = opt.scheduler()
        # one generator a tenant for its heavy draws
        self._gens = [torch.Generator(device=self.device).manual_seed(
            seed * 1_000_003 + t) for t in range(n_tenants)]
        self._ft_queue: "queue.Queue[FinetuneRequest]" = queue.Queue()
        self.completed_ft: Dict[int, FinetuneRequest] = {}
        self.ticks = 0
        self.engine = engine_lib.Engine(
            lm, None, batch_slots=batch_slots, max_len=max_len,
            eos_id=eos_id, seed=seed + 1, writer=writer,
            lane_params_fn=self._lane_params)

    # -- the fine-tune step of one work group ---------------------------------

    def _train_tick(self, picked: Dict[int, FinetuneRequest], group,
                    work: schedule.StepWork) -> Dict[int, float]:
        """One stacked step of the tenants ``group``: a backward each over
        views of its slice, then one bank update and its in-place
        application.  Returns {tenant: loss}."""
        dev = self.device
        grads = {k: [None] * self.n for k in self.params}
        acts_t, probe_t, losses = {}, {}, {}
        for t in group:
            p_t = {k: v[t].detach().requires_grad_()
                   for k, v in self.params.items()}
            probes = layers.make_probes(self.opt.taps, device=dev)
            batch = self._batch(t, picked[t])
            loss, acts, gp, gprobe = loop_lib.kfac_grads(
                self.lm.loss_fn, p_t, probes, batch)
            for k in grads:
                grads[k][t] = gp[k]
            acts_t[t], probe_t[t], losses[t] = acts, gprobe, loss
            del p_t, gp
        # the small per-tap statistics stacked on the tenant axis (zeros
        # for tenants outside the group: they are never read)
        def stack(per):
            one = per[group[0]]
            return {k: torch.stack([per[t][k] if t in per
                                    else torch.zeros_like(one[k])
                                    for t in range(self.n)])
                    for k in one}
        acts, probes = stack(acts_t), stack(probe_t)
        del acts_t, probe_t
        active = np.zeros((self.n,), bool)
        active[list(group)] = True
        # the bank drops each gradient once it has read it
        updates, self.state = self.bank.update(
            grads, self.state, self.params, acts=acts, probe_grads=probes,
            n_tokens=self.n_tokens, rngs=self._gens, work=work,
            active=active)
        del grads, acts, probes
        self.bank.apply_updates(self.params, updates, active=active)
        del updates
        return {t: float(v) for t, v in losses.items()}

    def _batch(self, t: int, req: FinetuneRequest) -> Dict[str, Any]:
        """The request's tokens and targets on the device, held to the
        service's fine-tune shape."""
        B, T = self.ft_shape
        out = {}
        for k in ("tokens", "targets"):
            arr = np.asarray(req.batch[k])
            if arr.shape != (B, T):
                raise ValueError(
                    f"tenant {t} batch {k!r} has shape {arr.shape}; "
                    f"the service's fine-tune cell is {(B, T)}")
            out[k] = torch.as_tensor(arr.astype(np.int64),
                                     device=self.device)
        return out

    # -- inference lane params ------------------------------------------------

    def _lane_params(self, slots):
        """Each tenant with a request in the batch → (views of its slice
        of the stacked weights, its lanes)."""
        lanes: Dict[int, List[int]] = {}
        for i, req in enumerate(slots):
            if req is not None:
                lanes.setdefault(int(req.tenant or 0), []).append(i)
        return [({k: v[t] for k, v in self.params.items()}, ix)
                for t, ix in sorted(lanes.items())]

    # -- admission ------------------------------------------------------------

    def submit(self, req):
        if isinstance(req, FinetuneRequest):
            if not 0 <= req.tenant < self.n:
                raise ValueError(f"unknown tenant {req.tenant} "
                                 f"(bank holds {self.n})")
            req.t_submit = time.time()
            self._ft_queue.put(req)
        else:
            if req.tenant is None:
                req.tenant = 0
            if not 0 <= req.tenant < self.n:
                raise ValueError(f"unknown tenant {req.tenant} "
                                 f"(bank holds {self.n})")
            self.engine.submit(req)

    def _admit_finetunes(self) -> Dict[int, FinetuneRequest]:
        """Pop at most one pending fine-tune per tenant for this tick
        (a tenant's later batches stay queued, FIFO — its optimizer
        state must advance one step at a time)."""
        picked: Dict[int, FinetuneRequest] = {}
        requeue = []
        while not self._ft_queue.empty():
            req = self._ft_queue.get()
            if req.tenant in picked:
                requeue.append(req)
            else:
                picked[req.tenant] = req
        for req in requeue:
            self._ft_queue.put(req)
        return picked

    # -- the tick -------------------------------------------------------------

    def tick(self):
        """One service tick: all pending fine-tunes (grouped by work
        mask, one stacked update per distinct mask) + one decode step."""
        picked = self._admit_finetunes()
        if picked:
            tenants = sorted(picked)
            groups = schedule.group_by_work(
                self.sched, [self.steps[t] for t in tenants])
            for work, idx in sorted(groups.items(), key=lambda kv: kv[1]):
                group = [tenants[i] for i in idx]
                losses = self._train_tick(picked, group, work)
                for t in group:
                    req = picked[t]
                    req.loss = losses[t]
                    req.step = self.steps[t]
                    req.t_done = time.time()
                    self.steps[t] += 1
                    self.completed_ft[req.uid] = req
                    if self.writer is not None:
                        self.writer.emit(
                            "tenant_update", tenant=t, step=req.step,
                            loss=req.loss, phase=work.label)
                        self.writer.emit(
                            "serve_request", uid=req.uid,
                            wait_s=req.t_done - req.t_submit,
                            total_s=req.t_done - req.t_submit,
                            n_new=0, tenant=t, kind="finetune")
        if (not self.engine._queue.empty()
                or any(s is not None for s in self.engine._slots)):
            self.engine.step()
        self.ticks += 1
        if (self.ckpt_dir is not None and self.ckpt_every > 0
                and self.ticks % self.ckpt_every == 0):
            self.save_checkpoint()

    # -- draining / reporting -------------------------------------------------

    def pending(self) -> bool:
        return (not self._ft_queue.empty()
                or not self.engine._queue.empty()
                or any(s is not None for s in self.engine._slots))

    def run_until_drained(self, max_ticks: int = 10_000) -> int:
        ticks = 0
        while self.pending() and ticks < max_ticks:
            self.tick()
            ticks += 1
        return ticks

    def latency_report(self) -> Dict[str, Any]:
        """p50/p99 per stream + per-tenant request counts."""
        def pcts(xs):
            xs = sorted(xs)
            if not xs:
                return {"requests": 0}
            pct = lambda q: xs[min(len(xs) - 1,
                                   int(round(q * (len(xs) - 1))))]
            return {"requests": len(xs), "p50_s": pct(0.5),
                    "p99_s": pct(0.99)}

        per_tenant: Dict[int, int] = {}
        for r in self.completed_ft.values():
            per_tenant[r.tenant] = per_tenant.get(r.tenant, 0) + 1
        for r in self.engine.completed.values():
            t = r.tenant or 0
            per_tenant[t] = per_tenant.get(t, 0) + 1
        return {
            "infer": self.engine.latency_report(),
            "finetune": pcts([r.t_done - r.t_submit
                              for r in self.completed_ft.values()]),
            "tenants": {str(t): c for t, c in sorted(per_tenant.items())},
            "steps": list(self.steps),
        }

    # -- checkpoint streaming -------------------------------------------------

    def tenant_table(self) -> List[dict]:
        return [{"tenant": t, "slot": t, "step": int(self.steps[t])}
                for t in range(self.n)]

    def save_checkpoint(self) -> Optional[str]:
        if self.ckpt_dir is None:
            return None
        path = ckpt_lib.save(self.ckpt_dir, self.ticks,
                             {"params": self.params, "opt": self.state},
                             tenants=self.tenant_table())
        ckpt_lib.prune(self.ckpt_dir, keep=self.ckpt_keep)
        if self.writer is not None:
            self.writer.emit("ckpt_save", step=self.ticks, path=path)
        return path

    def restore(self, directory: Optional[str] = None):
        """Re-seat the bank from the newest healthy snapshot: stacked
        params and state plus each tenant's local step out of the
        manifest's v6 ``tenants`` table (absent in a pre-v6 manifest: the
        steps stay)."""
        directory = directory or self.ckpt_dir
        tree, manifest = ckpt_lib.restore_latest_healthy(
            directory, {"params": self.params, "opt": self.state})
        self.params, self.state = tree["params"], tree["opt"]
        table = manifest.get("tenants") or []
        for row in table:
            self.steps[int(row["slot"])] = int(row["step"])
        return manifest
