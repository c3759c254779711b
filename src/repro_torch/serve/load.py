"""Synthetic mixed-traffic load generator for the multi-tenant service.

Counterpart of ``src/repro/serve/load.py``.  Drives a
:class:`~repro_torch.serve.service.TenantService` over a reduced LM with N
tenants and a mixed fine-tune/inference request stream submitted in
waves, then publishes the latency report:

    PYTHONPATH=src python -m repro_torch.serve.load \\
        --tenants 4 --waves 3 --infer-per-wave 4 --ft-per-wave 4 \\
        --telemetry-dir telem-serve [--device cpu]

Outputs:
  * ``<telemetry-dir>/events.jsonl`` — schema-validated ``serve_request``
    / ``tenant_update`` / ``ckpt_save`` events (``python -m
    repro_torch.obs.summary <file> --validate`` checks them)
  * ``<telemetry-dir>/latency.json`` — p50/p99 per stream + per-tenant
    request counts

The traffic is the reference's (numpy draws from ``--seed``); the
weights are the port's own, made from the seed.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch.configs.base import get_arch
from repro_torch.core import kfac as kfac_lib
from repro_torch.launch.steps import default_kfac_config
from repro_torch.models.lm import LM
from repro_torch.obs import TelemetryWriter
from repro_torch.serve.engine import Request
from repro_torch.serve.service import FinetuneRequest, TenantService


def finetune_kfac_config(arch, variant: str = "bkfac"
                         ) -> kfac_lib.KfacConfig:
    """``default_kfac_config`` at the fine-tune cadence.  The pretraining
    defaults refresh decompositions every T_updt = 25 steps, which leaves
    the warm-start spectrum empty (near-zero eigenvalues: the global-norm
    clip zeroes the first T_updt updates entirely).  A fine-tune tenant
    takes few, precious steps, so refresh every step and keep heavy
    passes frequent.  The kernels are on: on the card the factor and
    preconditioning work goes through the CUDA kernels, on the CPU
    through their plain versions."""
    return dataclasses.replace(
        default_kfac_config(arch, variant, use_kernels=True),
        T_updt=1, T_brand=1, T_inv=2, T_rsvd=2, T_corct=4)


def build_service(tenants: int = 4, variant: str = "bkfac",
                  arch_name: str = "gemma3_4b", seed: int = 0,
                  writer=None, ckpt_dir=None, ckpt_every: int = 0,
                  ft_batch: int = 2, ft_seq: int = 16,
                  batch_slots: int = 4, max_len: int = 48, device=None):
    """The service over ``arch_name``'s reduced config, random weights
    from ``seed``, on ``device`` (None: the card) → (service, arch)."""
    device = device_lib.resolve(device)
    arch = get_arch(arch_name).reduced()
    lm = LM(arch, remat=False, device=device)
    params = lm.init(torch.Generator(device=device).manual_seed(seed))
    opt = kfac_lib.Kfac(finetune_kfac_config(arch, variant), lm.taps,
                        device=device)
    svc = TenantService(lm, opt, params, tenants, ft_batch=ft_batch,
                        ft_seq=ft_seq, batch_slots=batch_slots,
                        max_len=max_len, seed=seed, writer=writer,
                        ckpt_dir=ckpt_dir, ckpt_every=ckpt_every)
    return svc, arch


def traffic(svc: TenantService, vocab: int, wave: int, rng,
            infer_per_wave: int, ft_per_wave: int, uid: int):
    """One wave's requests (tenants round-robin) → (requests, next
    uid)."""
    B, T = svc.ft_shape
    out = []
    for i in range(infer_per_wave):
        t = (wave * infer_per_wave + i) % svc.n
        prompt = rng.integers(1, vocab, size=rng.integers(2, 6)).tolist()
        out.append(Request(uid=uid, prompt=prompt, max_new=4, tenant=t))
        uid += 1
    for i in range(ft_per_wave):
        t = (wave * ft_per_wave + i) % svc.n
        batch = {
            "tokens": rng.integers(0, vocab, size=(B, T),
                                   dtype=np.int64).astype(np.int32),
            "targets": rng.integers(0, vocab, size=(B, T),
                                    dtype=np.int64).astype(np.int32),
        }
        out.append(FinetuneRequest(uid=uid, tenant=t, batch=batch))
        uid += 1
    return out, uid


def run_load(svc: TenantService, vocab: int, waves: int = 3,
             infer_per_wave: int = 4, ft_per_wave: int = 4,
             ticks_between: int = 4, seed: int = 0,
             max_ticks: int = 2000) -> int:
    """Submit ``waves`` rounds of mixed traffic (tenants round-robin),
    ticking between rounds so requests overlap in flight — staggered
    admission is exactly what the per-slot/per-tenant paths must get
    right.  Returns total ticks run."""
    rng = np.random.default_rng(seed)
    uid = 0
    total = 0
    for w in range(waves):
        reqs, uid = traffic(svc, vocab, w, rng, infer_per_wave,
                            ft_per_wave, uid)
        for r in reqs:
            svc.submit(r)
        for _ in range(ticks_between):
            svc.tick()
            total += 1
    total += svc.run_until_drained(max_ticks=max_ticks - total)
    return total


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tenants", type=int, default=4)
    ap.add_argument("--variant", default="bkfac")
    ap.add_argument("--arch", default="gemma3_4b")
    ap.add_argument("--waves", type=int, default=3)
    ap.add_argument("--infer-per-wave", type=int, default=4)
    ap.add_argument("--ft-per-wave", type=int, default=4)
    ap.add_argument("--ticks-between", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--telemetry-dir", default="telem-serve")
    ap.add_argument("--ckpt-every", type=int, default=0,
                    help="stream a v6 tenant-table checkpoint every N "
                         "ticks into <telemetry-dir>/ckpt (0 = off)")
    ap.add_argument("--device", default=None,
                    help="default: cuda (a host without a card raises)")
    args = ap.parse_args(argv)

    device = device_lib.resolve(args.device)
    os.makedirs(args.telemetry_dir, exist_ok=True)
    events = os.path.join(args.telemetry_dir, "events.jsonl")
    ckpt_dir = (os.path.join(args.telemetry_dir, "ckpt")
                if args.ckpt_every > 0 else None)
    with TelemetryWriter(events, console=False) as writer:
        writer.emit("run_start", config={
            "mode": "serve-load", "tenants": args.tenants,
            "variant": args.variant, "arch": args.arch,
            "waves": args.waves, "device": device.type})
        svc, arch = build_service(
            args.tenants, variant=args.variant, arch_name=args.arch,
            seed=args.seed, writer=writer, ckpt_dir=ckpt_dir,
            ckpt_every=args.ckpt_every, device=device)
        ticks = run_load(svc, arch.vocab, waves=args.waves,
                         infer_per_wave=args.infer_per_wave,
                         ft_per_wave=args.ft_per_wave,
                         ticks_between=args.ticks_between,
                         seed=args.seed)
        report = svc.latency_report()
        report["ticks"] = ticks
        n_done = (report["infer"].get("requests", 0)
                  + report["finetune"].get("requests", 0))
        writer.emit("log", msg=f"serve load done: {n_done} requests over "
                               f"{args.tenants} tenants in {ticks} ticks")
    out = os.path.join(args.telemetry_dir, "latency.json")
    with open(out, "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps(report, indent=2))
    expect = args.waves * (args.infer_per_wave + args.ft_per_wave)
    if n_done != expect:
        raise SystemExit(f"served {n_done}/{expect} requests")
    return report


if __name__ == "__main__":
    main()
