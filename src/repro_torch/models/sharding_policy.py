"""Activation-sharding policy threaded through the models.

Counterpart of ``src/repro/models/sharding_policy.py``: the same policy
fields and activation roles, so the models call the reference's methods
at the reference's places.

**Data parallelism.**  On a mesh whose data axes (``dp``: every axis but
"model") have more than one member, each rank holds its block of the
global batch: ``dp_index`` counts the ranks row-major over ``dp``, as
``distributed/sharding.py::batch_sharding`` lays the batch out, and
``dp_size`` is their number.  Every activation role is then the identity
on the rank's rows; what couples the rows of a batch is done by the
models through this policy's collectives over the data axes: the taps'
statistics rows (``layers.tapped_matmul``: each rank places its rows of
the global slice, and :meth:`dp_sum` adds the ranks' placements), the
MoE capacity and load-balance loss (``models/moe.py``) and the loss's
normalisation (``models/lm.py``).  ``mesh`` is the ``launch/mesh.py``
mesh those collectives run over.

A model axis larger than 1 would need tensor-parallel execution (heads,
FFN and vocabulary split over "model", sequence-parallel residuals),
which the port does not have (ROADMAP §1 item 6): every role then raises.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

import torch

from repro_torch.distributed import collectives as coll

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class ShardPolicy:
    dp: Tuple[str, ...] = ()          # data axes ("pod","data") or ("data",)
    tp: Optional[str] = None          # model axis
    seq_shard_residual: bool = True   # sequence parallelism on residuals
    shard_kv_seq: bool = False        # long-context: shard cache seq over dp
    axis_sizes: Tuple[Tuple[str, int], ...] = ()   # mesh axis → size
    kv_cache_layout: str = "seq"
    kv_small_seq_threshold: int = 0
    mesh: Any = dataclasses.field(default=None, compare=False, repr=False)

    @property
    def active(self) -> bool:
        return bool(self.dp) or self.tp is not None

    # --- data parallelism ---------------------------------------------------
    @property
    def dp_size(self) -> int:
        """Ranks the batch is split over (the data axes' sizes' product)."""
        sizes = dict(self.axis_sizes)
        return math.prod(sizes.get(a, 1) for a in self.dp)

    @property
    def data_parallel(self) -> bool:
        return self.dp_size > 1

    @property
    def dp_index(self) -> int:
        """This rank's block of the batch: its coordinates on the data
        axes, row-major (0 without data parallelism)."""
        if not self.data_parallel:
            return 0
        sizes, idx = dict(self.axis_sizes), 0
        for a in self.dp:
            idx = idx * sizes[a] + self.mesh.coord(a)
        return idx

    def dp_sum(self, x: Tensor) -> Tensor:
        """``x`` summed over the data axes, in place (no autograd)."""
        if not self.data_parallel:
            return x
        return coll.all_reduce(x, self.mesh, tuple(self.dp))

    def dp_sum_all(self, xs) -> None:
        """Every tensor of ``xs`` summed over the data axes, in place, in
        packed buffers (``collectives.all_reduce_coalesced``)."""
        if self.data_parallel:
            coll.all_reduce_coalesced(list(xs), self.mesh, tuple(self.dp))

    def dp_sum_grad(self, x: Tensor) -> Tensor:
        """``x`` summed over the data axes, differentiably: the backward
        sums the ranks' gradients (each rank's loss holds its share)."""
        if not self.data_parallel:
            return x
        return coll.all_reduce_autograd(x, self.mesh, tuple(self.dp))

    def dp_gather(self, x: Tensor, dim: int = 0) -> Tensor:
        """The ranks' ``x`` concatenated along ``dim`` in batch order."""
        if not self.data_parallel:
            return x
        return coll.all_gather(x, self.mesh, tuple(self.dp), dim)

    @property
    def model_parallel(self) -> bool:
        """True iff the policy shards over a model axis larger than 1."""
        return self.tp is not None and dict(self.axis_sizes).get(
            self.tp, 1) > 1

    def _c(self, x: Tensor) -> Tensor:
        if self.model_parallel:
            raise NotImplementedError(
                "a model axis larger than 1 needs tensor-parallel "
                "execution, which is not ported (ROADMAP §1 item 5, "
                "'Tensor-parallel execution'); use a mesh of data and "
                "curvature axes")
        return x

    # --- activation roles (the identity on a rank's rows) ------------------
    def residual(self, h: Tensor) -> Tensor:
        """(B, T, d) between blocks."""
        return self._c(h)

    def full_seq(self, h: Tensor) -> Tensor:
        """(B, T, d) inside blocks (sequence gathered)."""
        return self._c(h)

    def heads(self, x: Tensor) -> Tensor:
        """(B, T, H, hd) — heads on the model axis."""
        return self._c(x)

    def ffn_hidden(self, x: Tensor) -> Tensor:
        """(B, T, f) — hidden on the model axis."""
        return self._c(x)

    def moe_buffers(self, x: Tensor) -> Tensor:
        """(E, C, d) — experts on model, capacity on data."""
        return self._c(x)

    def logits(self, x: Tensor) -> Tensor:
        """(B, T, V) — vocab on the model axis."""
        return self._c(x)

    def kv_cache(self, x: Tensor) -> Tensor:
        """Decode cache (…, B, S, *inner)."""
        return self._c(x)

    def state(self, x: Tensor) -> Tensor:
        """Recurrent state (B, ...)."""
        return self._c(x)


NO_SHARD = ShardPolicy()
