"""Quickstart: train a small MLP with B-KFAC (the paper's optimizer).

Counterpart of ``examples/quickstart.py``: the same MLP (32 → 256 → 8,
batch 64, n_stat 32), B-KFAC with r = 32, T_updt = T_brand = 1, 50
steps, and the same check that the loss falls below 0.3 of its start.

    PYTHONPATH=src python -m repro_torch.examples.quickstart   # the card
    PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu

The weights and batches come from torch generators, so the numbers are
not the reference's; ``tests/test_torch_baselines.py`` feeds this loss
the reference's weights and batches and holds the trajectory to its.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch import device as device_lib
from repro_torch.core import kfac as kfac_lib
from repro_torch.core import policy as policy_lib
from repro_torch.models import layers
from repro_torch.optim import base as optbase
from repro_torch.train import loop

D_IN, D_H, D_OUT, BATCH, N_STAT, STEPS = 32, 256, 8, 64, 32, 50

# 1) a model with K-FAC taps: each tapped matmul gets a TapInfo
TAPS = {
    "fc0": kfac_lib.TapInfo("fc0/w", D_IN, D_H, n_stat=N_STAT),
    "fc1": kfac_lib.TapInfo("fc1/w", D_H, D_OUT, n_stat=N_STAT),
}


def init(seed: int, device) -> dict:
    g = torch.Generator(device=device).manual_seed(seed)
    return {"fc0/w": layers.dense_init(g, D_IN, D_H, device=device),
            "fc1/w": layers.dense_init(g, D_H, D_OUT, device=device)}


def loss_fn(params, probes, batch):
    x, y = batch
    acts = {}
    h, acts["fc0"] = layers.tapped_matmul(params["fc0/w"], x,
                                          probes.get("fc0"), N_STAT)
    h = torch.relu(h)
    out, acts["fc1"] = layers.tapped_matmul(params["fc1/w"], h,
                                            probes.get("fc1"), N_STAT)
    return torch.mean((out - y) ** 2), acts


def make_batches(seed: int, device) -> list:
    g = torch.Generator(device=device).manual_seed(seed)
    W_true = torch.randn((D_IN, D_OUT), generator=g, device=device)
    xs = [torch.randn((BATCH, D_IN), generator=g, device=device)
          for _ in range(STEPS)]
    return [(x, torch.tanh(x @ W_true)) for x in xs]


# 2) pick a paper variant: bkfac | brkfac | bkfacc | rkfac | kfac
def make_opt(device) -> kfac_lib.Kfac:
    cfg = kfac_lib.KfacConfig(
        policy=policy_lib.PolicyConfig(variant="bkfac", r=32),
        lr=optbase.constant(0.05), damping_phi=optbase.constant(0.1),
        clip=1.0, T_updt=1, T_brand=1)
    return kfac_lib.Kfac(cfg, TAPS, device=device)


# 3) train
def train(params: dict, batches: list, device) -> list:
    params = {k: v.detach().clone().requires_grad_()
              for k, v in params.items()}
    _, losses = loop.run_kfac_training(loss_fn, make_opt(device), params,
                                       batches, n_tokens=BATCH,
                                       device=device)
    return losses


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="default: cuda (a host without a card raises)")
    device = device_lib.resolve(ap.parse_args(argv).device)
    losses = train(init(1, device), make_batches(0, device), device)
    print(f"loss: {losses[0]:.4f} -> {losses[-1]:.4f} (bkfac, "
          f"{len(losses)} steps, {device.type})")
    if not losses[-1] < 0.3 * losses[0]:
        raise SystemExit(f"loss did not fall below 0.3 of its start: "
                         f"{losses[0]:.4f} -> {losses[-1]:.4f}")
    print("OK")


if __name__ == "__main__":
    main()
