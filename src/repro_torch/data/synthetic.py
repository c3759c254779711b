"""Deterministic synthetic data streams (no external datasets).

Counterpart of ``src/repro/data/synthetic.py``:

* ``TokenStream`` — LM token batches with learnable structure: a fixed
  random bigram teacher that each next token follows with probability
  ``structure`` (else a uniform draw), so the cross-entropy can drop
  below uniform.
* ``ImageStream`` — CIFAR-like (B, 32, 32, 3) NHWC images, 10 classes,
  labelled by a fixed random linear teacher plus noise.

Both draw from their own ``torch.Generator`` streams, so their numbers are
not the reference's; the parity tests feed both packages the reference's
draws (``TokenStream.batch_at``'s optional arguments) or batches instead.
Each batch is a pure function of (seed, step), made on the target device.

On a data mesh a rank trains on its block of the global batch: every
rank draws the global batch (the same seed, so the same batch) and
:func:`rank_rows` keeps its block of the rows — of the tokens, and of
the encoder-decoder ``frames`` and the vision ``embeds`` of
``launch/steps.py::train_batch_specs``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping, Optional, Tuple

import torch

from repro_torch import device as device_lib

Tensor = torch.Tensor


def rank_rows(batch, index: int, count: int):
    """Rows block ``index`` of ``count`` (in batch order) of a tensor, or
    of every tensor of a mapping, along the leading (batch) dimension."""
    if isinstance(batch, Mapping):
        return {k: rank_rows(v, index, count) for k, v in batch.items()}
    if count == 1:
        return batch
    B = batch.shape[0]
    if B % count:
        raise ValueError(f"a batch of {B} rows does not split over "
                         f"{count} data ranks")
    return batch[index * (B // count):(index + 1) * (B // count)]


@dataclasses.dataclass(frozen=True)
class TokenStream:
    vocab: int
    batch: int
    seq_len: int
    seed: int = 0
    structure: float = 0.7      # prob of following the bigram teacher
    device: object = None            # None: the card

    def _teacher(self, dev) -> Tensor:
        g = torch.Generator(device=dev).manual_seed(self.seed)
        return torch.randint(0, self.vocab, (self.vocab,), generator=g,
                             device=dev)

    def batch_at(self, step: int, teacher: Optional[Tensor] = None,
                 first: Optional[Tensor] = None,
                 noise: Optional[Tensor] = None,
                 follow: Optional[Tensor] = None) -> Dict[str, Tensor]:
        """Batch for a given step — deterministic, restart-safe.  Each of
        the draws (the teacher table (vocab,), ``first`` (B, 1), ``noise``
        (B, T) and the bernoulli ``follow`` (B, T)) may be passed in, as
        the parity tests pass the reference's; the rest are drawn here.
        Token t+1 is ``teacher[token t]`` where ``follow[:, t]``, else
        ``noise[:, t]``."""
        dev = device_lib.resolve(self.device)
        B, T = self.batch, self.seq_len
        g = torch.Generator(device=dev).manual_seed(
            (self.seed + 1) * 1_000_003 + step)
        nxt = (self._teacher(dev) if teacher is None else teacher.to(dev))
        if first is None:
            first = torch.randint(0, self.vocab, (B, 1), generator=g,
                                  device=dev)
        if noise is None:
            noise = torch.randint(0, self.vocab, (B, T), generator=g,
                                  device=dev)
        if follow is None:
            follow = torch.rand((B, T), generator=g,
                                device=dev) < self.structure
        first, noise = first.to(dev, torch.int64), noise.to(dev, torch.int64)
        follow = follow.to(dev, torch.bool)
        nxt = nxt.to(torch.int64)
        tokens = torch.empty((B, T), dtype=torch.int64, device=dev)
        tokens[:, 0] = first[:, 0]
        for t in range(T - 1):
            tokens[:, t + 1] = torch.where(follow[:, t], nxt[tokens[:, t]],
                                           noise[:, t])
        return {"tokens": tokens, "targets": tokens}


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
