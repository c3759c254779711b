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

**Tensor parallelism.**  On a model axis ("model", ``tp``) of
``tp_size`` > 1 members each rank holds its contiguous block of every
parameter ``distributed/sharding.py::params_sharding`` shards (heads,
FFN hidden, experts, vocabulary), and the models run Megatron-style with
explicit collectives over that axis (``distributed/collectives.py``):
the residual stream between blocks is sequence-sharded (:meth:`residual`
takes a rank's T-block of a whole tensor, :meth:`residual_reduce`
reduce-scatters a row-parallel product's partial sums over T), a block
gathers it (:meth:`full_seq`), column-parallel matmuls give the rank's
output columns (:meth:`gather_cols` joins them where a consumer needs
every column), and :meth:`heads`, :meth:`ffn_hidden` and
:meth:`moe_buffers` take the rank's block of a whole tensor (the head's
column-parallel matmul gives the rank's vocabulary block of the logits
itself).  ``seq`` is
the global sequence length of the forward the policy runs
(:meth:`for_seq`); as in the reference's ``_c`` an axis that does not
divide its dimension is dropped, so a length the model axis does not
divide (T = 1 in decode, an odd prefix-plus-tokens length) leaves the
residual replicated.  The convention over "model" is the data axes' one:
each rank's loss is a 1/``tp_size`` share, every collective's backward
is its adjoint, and a replicated parameter's gradient is the sum of the
ranks' parts (``train/loop.py::kfac_grads``).  ``shards`` (set by
``models/lm.py::LM``) knows which parameters a rank holds a block of.
The decode caches' layouts are read by ``models/blocks.py`` through
:meth:`kv_seq_block` and :meth:`cache_axes`.

**FSDP** (``launch/steps.py``'s ``plan="fsdp"``): the data axes are every
axis of the mesh and there is no model axis, so every role is the data
axes' identity; ``shards`` is then ``ModelShards`` over the whole mesh
(:attr:`fsdp`), each rank holds its block of every parameter, and
``models/lm.py`` gathers a layer's parameters as it runs it.
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
    seq: int = 0                      # the forward's global length
    shards: Any = dataclasses.field(default=None, compare=False, repr=False)
    #: decode caches' global lengths: (self-attention S, cross length,
    #: whether sliding-window layers keep a window-slot ring)
    kv_lens: Tuple[int, int, bool] = (0, 0, False)
    #: a data-parallel rank's MoE buffer rows (``models/moe.py``): "kept"
    #: its largest kept count (read from the device), "even" ⌈C / data
    #: ranks⌉ (no read: the meta-tensor dry-run's rule)
    moe_capacity: str = "kept"

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

    @property
    def fsdp(self) -> bool:
        """True iff the parameters are split over every axis (``shards``
        FSDP's, set by ``models/lm.py::LM``): the batch is split over
        every axis too, and its sums run over the whole mesh at once."""
        return bool(getattr(self.shards, "fsdp", False))

    @property
    def _dp_axes(self):
        return None if self.fsdp else tuple(self.dp)

    def dp_sum(self, x: Tensor) -> Tensor:
        """``x`` summed over the data axes, in place (no autograd)."""
        if not self.data_parallel:
            return x
        return coll.all_reduce(x, self.mesh, self._dp_axes)

    def dp_sum_all(self, xs) -> None:
        """Every tensor of ``xs`` summed over the data axes, in place, in
        packed buffers (``collectives.all_reduce_coalesced``)."""
        if self.data_parallel:
            coll.all_reduce_coalesced(list(xs), self.mesh, self._dp_axes)

    def dp_sum_grad(self, x: Tensor) -> Tensor:
        """``x`` summed over the data axes, differentiably: the backward
        sums the ranks' gradients (each rank's loss holds its share)."""
        if not self.data_parallel:
            return x
        return coll.all_reduce_autograd(x, self.mesh, self._dp_axes)

    def dp_gather(self, x: Tensor, dim: int = 0) -> Tensor:
        """The ranks' ``x`` concatenated along ``dim`` in batch order."""
        if not self.data_parallel:
            return x
        return coll.all_gather(x, self.mesh, tuple(self.dp), dim)

    # --- tensor parallelism -------------------------------------------------
    @property
    def tp_size(self) -> int:
        return dict(self.axis_sizes).get(self.tp, 1) if self.tp else 1

    @property
    def model_parallel(self) -> bool:
        """True iff the policy shards over a model axis larger than 1."""
        return self.tp_size > 1

    @property
    def tp_index(self) -> int:
        return self.mesh.coord(self.tp) if self.model_parallel else 0

    def for_seq(self, T: int) -> "ShardPolicy":
        """This policy for a forward over a global sequence of ``T``."""
        if not self.model_parallel or self.seq == T:
            return self
        return dataclasses.replace(self, seq=T)

    @property
    def seq_sharded(self) -> bool:
        """Whether the residual stream is split over T on the model axis
        (``_c``'s fit rule: the axis must divide T)."""
        return (self.model_parallel and self.seq_shard_residual
                and self.seq > 0 and self.seq % self.tp_size == 0)

    def block(self, x: Tensor, dim: int) -> Tensor:
        """The rank's block of a whole (replicated) ``x`` along ``dim``;
        ``x`` itself where the model axis does not divide it."""
        n = self.tp_size
        if n == 1 or x.shape[dim] % n:
            return x
        size = x.shape[dim] // n
        return x.narrow(dim, self.tp_index * size, size)

    def block_range(self, total: int, local: int) -> Tuple[int, int]:
        """[lo, hi) of the rank's block of a dimension of ``total``
        entries of which it holds ``local`` (the whole: (0, total))."""
        if local == total:
            return 0, total
        return self.tp_index * local, (self.tp_index + 1) * local

    def tp_sum(self, x: Tensor) -> Tensor:
        """``x`` summed over the model axis, differentiably (adjoint:
        the same sum of the gradients)."""
        if not self.model_parallel:
            return x
        return coll.all_reduce_autograd(x, self.mesh, self.tp)

    def tp_max(self, x: Tensor) -> Tensor:
        """The elementwise max over the model axis (no gradient)."""
        if not self.model_parallel:
            return x
        return coll.all_reduce_max(x, self.mesh, self.tp)

    def gather_cols(self, y: Tensor, total: int, dim: int = -1) -> Tensor:
        """A column-parallel output's blocks joined along ``dim`` to its
        ``total`` entries (the identity where ``y`` is whole)."""
        if y.shape[dim] == total:
            return y
        return coll.gather_grad(y, self.mesh, self.tp, dim % y.dim())

    def as_partial(self, y: Tensor) -> Tensor:
        """A whole (replicated) ``y`` as a partial sum over the model
        axis: rank 0's copy, zeros on the others (differentiably, so each
        rank's graph keeps its inputs)."""
        if not self.model_parallel or self.tp_index == 0:
            return y
        return y * 0

    # --- activation roles ----------------------------------------------------
    def residual(self, h: Tensor) -> Tensor:
        """(B, T, d) between blocks: the rank's T-block of a whole
        ``h`` when the residual is sequence-sharded."""
        return self.block(h, 1) if self.seq_sharded else h

    def residual_reduce(self, o: Tensor) -> Tensor:
        """A row-parallel product's partial sums (B, T, d) into the
        residual's layout: reduce-scattered over T (sequence-sharded),
        else summed over the model axis."""
        if not self.model_parallel:
            return o
        if self.seq_sharded:
            return coll.reduce_scatter_grad(o, self.mesh, self.tp, 1)
        return coll.all_reduce_autograd(o, self.mesh, self.tp)

    def full_seq(self, h: Tensor) -> Tensor:
        """(B, T, d) inside blocks (sequence gathered)."""
        if not self.seq_sharded:
            return h
        return coll.gather_grad(h, self.mesh, self.tp, 1)

    def heads(self, x: Tensor) -> Tensor:
        """(B, T, H, hd) — the rank's heads of a whole ``x``."""
        return self.block(x, 2)

    def ffn_hidden(self, x: Tensor) -> Tensor:
        """(B, T, f) — the rank's hidden block of a whole ``x``."""
        return self.block(x, -1)

    def moe_buffers(self, x: Tensor) -> Tensor:
        """(E, C, d) — the rank's experts of a whole ``x``."""
        return self.block(x, 0)

    def cache_axes(self) -> Tuple[str, ...]:
        """The axes a decode cache's sequence is split over: every axis
        under ``shard_kv_seq`` (long context, B = 1), else "model"."""
        if self.shard_kv_seq:
            return tuple(self.dp) + ((self.tp,) if self.tp else ())
        return (self.tp,) if self.tp else ()

    def kv_seq_block(self, S: int) -> Tuple[int, int]:
        """(shards, this rank's shard) of a cache sequence of ``S`` slots
        in the sequence layout: the ``cache_axes`` row-major, dropped
        where they do not divide ``S`` ((1, 0): replicated)."""
        sizes = dict(self.axis_sizes)
        axes = self.cache_axes()
        n = math.prod(sizes.get(a, 1) for a in axes)
        if n == 1 or S % n:
            return 1, 0
        idx = 0
        for a in axes:
            idx = idx * sizes[a] + self.mesh.coord(a)
        return n, idx

    def kv_cache(self, x: Tensor) -> Tensor:
        """Decode cache (…, B, S, *inner): a rank holds its block of the
        layout's dimension already (``cache_sharding``), so the identity;
        the decode blocks read the layout from ``kv_cache_layout``,
        :meth:`kv_seq_block` and the cache's shape."""
        return x

    def state(self, x: Tensor) -> Tensor:
        """Recurrent state (B, ...): replicated over the model axis."""
        return x


NO_SHARD = ShardPolicy()
