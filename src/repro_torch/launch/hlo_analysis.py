"""The dry-run's accounting of a step: matmul flops and collective bytes.

Counterpart of ``src/repro/launch/hlo_analysis.py``, which parses the
optimized HLO text of a compiled module.  The port has no HLO: its steps
run eagerly, so the same two figures are counted while a step runs
(``launch/dryrun.py`` runs it on meta tensors, where nothing is computed):

  * :class:`DotCounter` is a ``TorchDispatchMode`` that adds each
    matmul-family op's flops (``torch.utils.flop_counter``'s formulas:
    ``mm``, ``addmm``, ``bmm``, ``baddbmm``, the convolutions and their
    backward, the fused attention kernels) by the dtype of its first
    operand.  These are what XLA lowers to ``dot`` (and ``convolution``):
    2·|out|·Π(contracting dims) a product, as the reference's
    :func:`dot_flops` counts them; ``eigh``, ``qr``, ``cholesky`` and the
    triangular solves count nothing on either side (XLA makes them custom
    calls, which the reference's parser does not count).  Elementwise work
    is not counted, as the reference's dot count leaves it out.
  * :func:`collective_bytes` reads ``distributed/collectives.py``'s
    counter (``collectives.counting``), which keeps the reference's
    convention beside the port's own: an all-gather counts its output, an
    all-reduce its tensor, a reduce-scatter its operand.

A loop over layers runs every repeat, so nothing is undercounted: the
reference's scan correction has no counterpart here.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten


class DotCounter(TorchDispatchMode):
    """Counts the matmul flops of the ops dispatched while it is entered,
    by the dtype of each op's first tensor operand (``by_dtype``: dtype
    name → flops).  It reads shapes only."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._registry = flop_registry
        self.by_dtype: Dict[str, float] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        count = self._registry.get(func._overloadpacket)
        if count is not None:
            flops = count(*args, **kwargs, out_val=out)
            first = next(t for t in tree_flatten((args, kwargs))[0]
                         if isinstance(t, torch.Tensor))
            key = str(first.dtype).replace("torch.", "")
            self.by_dtype[key] = self.by_dtype.get(key, 0.0) + float(flops)
        return out

    @property
    def total(self) -> float:
        return float(sum(self.by_dtype.values()))


def dot_flops(counter: DotCounter) -> float:
    """Matmul FLOPs of the counted step: Σ over products of
    2 · |output| · Π(contracting dims)."""
    return counter.total


def dot_flops_by_dtype(counter: DotCounter) -> Dict[str, float]:
    """:func:`dot_flops` split by operand dtype ("bfloat16", "float32",
    …): bf16 and fp32 products run at different peaks on the card."""
    return dict(counter.by_dtype)


def collective_bytes(tally) -> Tuple[int, Dict[str, int]]:
    """→ (total_bytes, per-kind breakdown) of a ``collectives.counting``
    tally, in the reference's shape: each kind's bytes and its
    ``<kind>_count``."""
    return int(tally.total), dict(tally.by_kind)
