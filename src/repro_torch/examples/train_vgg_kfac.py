"""The paper's §6 experiment on one GPU: modified VGG16_bn (2×1 pooling →
16384×2048 FC0) on a CIFAR-like stream, trained by a K-FAC variant.

Counterpart of ``examples/train_vgg_kfac.py``:

    PYTHONPATH=src python -m repro_torch.examples.train_vgg_kfac \
        --preset paper --steps 50

Presets: ``small`` (a quick check) and ``paper`` (stages 64-128-256-512-512,
FC hidden 2048, n_stat 256, r 230).  ``--optimizer`` takes every variant
of the reference (kfac, rkfac, bkfac, brkfac, bkfacc, nskfac).  On the card
the EA absorb, the Brand update, the Newton–Schulz refinement and the
preconditioning go through the CUDA kernels (``use_kernels=True``).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch.core import kfac as kfac_lib
from repro_torch.core import policy as policy_lib
from repro_torch.data.synthetic import ImageStream
from repro_torch.models.cnn import VggConfig, make_vgg
from repro_torch.optim import base as optbase
from repro_torch.train import loop


def build(preset: str, optimizer: str = "bkfac", batch: int = 128,
          device=None, use_kernels: bool = True, stagger: bool = False,
          stagger_splits: int = 4, seed: int = 0):
    """(model, Kfac, ImageStream) for a preset, as the reference example
    configures them (T_updt = T_brand = 5, T_inv = 25, max_dense_dim
    4096, the paper's lr and damping staircases at 50 steps per epoch)."""
    device = device_lib.resolve(device)
    if preset == "paper":
        cfg = VggConfig(stages=(64, 128, 256, 512, 512), fc_hidden=2048,
                        n_stat=256)
        r = 230
    elif preset == "small":
        cfg = VggConfig(stages=(16, 32, 64), fc_hidden=512, n_stat=64)
        r = 96
    else:
        raise ValueError(f"unknown preset {preset!r}")
    model, taps = make_vgg(cfg, device=device, seed=seed)
    kcfg = kfac_lib.KfacConfig(
        policy=policy_lib.PolicyConfig(variant=optimizer, r=r,
                                       max_dense_dim=4096),
        lr=optbase.paper_lr_schedule(steps_per_epoch=50),
        damping_phi=optbase.paper_damping_schedule(steps_per_epoch=50),
        weight_decay=7e-4, clip=0.5,
        T_updt=5, T_inv=25, T_brand=5, T_rsvd=25, T_corct=25,
        stagger=stagger, stagger_splits=stagger_splits,
        use_kernels=use_kernels, fallback_lr=optbase.constant(3e-3))
    opt = kfac_lib.Kfac(kcfg, taps, device=device)
    return model, opt, ImageStream(batch=batch, seed=seed, device=device)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--optimizer", default="bkfac",
                    choices=list(policy_lib.VARIANTS))
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--preset", default="small", choices=("small", "paper"))
    ap.add_argument("--stagger", action="store_true")
    ap.add_argument("--stagger-splits", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="default: cuda (a host without a card raises)")
    args = ap.parse_args(argv)

    model, opt, stream = build(args.preset, args.optimizer, args.batch,
                               device=args.device,
                               stagger=args.stagger,
                               stagger_splits=args.stagger_splits)
    batches = (stream.batch_at(i) for i in range(args.steps))
    holdout = stream.batch_at(10_000)
    params = model.params()
    t0 = time.time()

    def cb(k, state, loss):
        if k % 10 == 0:
            acc = float(model.accuracy(params, holdout))
            print(f"step {k:4d}  loss {float(loss):.4f}  "
                  f"holdout-acc {acc:.3f}  ({time.time() - t0:.0f}s)",
                  flush=True)

    state, losses = loop.run_kfac_training(model.loss, opt, params, batches,
                                           n_tokens=args.batch, callback=cb,
                                           device=opt.device)
    if opt.device.type == "cuda":
        torch.cuda.synchronize()
    acc = float(model.accuracy(params, holdout))
    print(f"[{args.optimizer}] final loss {np.mean(losses[-5:]):.4f}  "
          f"holdout-acc {acc:.3f}  total {time.time() - t0:.0f}s")


if __name__ == "__main__":
    main()
