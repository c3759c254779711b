"""Deterministic synthetic image batches (no external datasets).

Counterpart of ``src/repro/data/synthetic.py::ImageStream``: CIFAR-like
(B, 32, 32, 3) NHWC images, 10 classes, labelled by a fixed random linear
teacher plus noise.  It draws from its own ``torch.Generator`` stream, so
its numbers are not the reference's; the parity tests feed both packages
the reference's batches instead.  Each batch is a pure function of
(seed, step), made on the target device.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch

from repro_torch import device as device_lib

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class ImageStream:
    batch: int
    seed: int = 0
    n_classes: int = 10
    margin: float = 2.0
    device: object = None            # None: the card

    def batch_at(self, step: int) -> Tuple[Tensor, Tensor]:
        dev = device_lib.resolve(self.device)
        g = torch.Generator(device=dev).manual_seed(
            (self.seed + 17) * 1_000_003 + step)
        x = torch.randn((self.batch, 32, 32, 3), generator=g, device=dev)
        wg = torch.Generator(device=dev).manual_seed(self.seed + 29)
        W = torch.randn((32 * 32 * 3, self.n_classes), generator=wg,
                        device=dev)
        logits = x.reshape(self.batch, -1) @ W / math.sqrt(32 * 32 * 3)
        noise = torch.randn(logits.shape, generator=g, device=dev)
        y = torch.argmax(logits + noise / self.margin, dim=-1)
        return x, y
