"""The collectives of the distributed layer, over a mesh's process groups.

The transport the curvature engine, the sharding helpers and the health
guards use; ``launch/mesh.py`` builds the meshes they run over.  A mesh
here is anything with ``shape`` (axis → size), ``size`` and
``group(axis)`` (:class:`repro_torch.launch.mesh.Mesh`).

:func:`all_gather` is ``jax.lax.all_gather(x, axis, axis=dim,
tiled=True)``: the list form of ``dist.all_gather``, which gloo and NCCL
both take, then one concatenation.  :func:`backend_for` picks a world's
backend: ``gloo`` on the CPU; ``nccl`` on cards when every rank has a
card of its own; ``gloo`` when ranks share a card (NCCL refuses two
ranks on one GPU).  Either way the ranks' arithmetic stays on their
device; only the transport differs.

An ``axis`` may also name several axes, ``("pod", "data")``: the data
axes over which the batch is sharded.  Their members are ordered
row-major (the first axis outermost), as ``jax.sharding`` lays a batch
dimension out over a tuple of axes; a gather over them gathers over the
last axis first, a reduction reduces over each in turn.
:func:`all_reduce_autograd` is the sum whose backward is the same sum of
the gradients (``torch.distributed.nn.functional.all_reduce``'s
semantics, over these groups): where a reduced quantity feeds every
rank's share of the loss, each rank's parameters get the gradient of the
whole.

**Tensor parallelism** (a model axis larger than 1) uses the autograd
collectives below.  The port's convention over the model axis is the
data axes' one: each rank's loss is a 1/M share of the global loss, so
the backward of every collective is its adjoint — :func:`gather_grad`
(all-gather along a dim) reduce-scatters, :func:`reduce_scatter_grad`
gathers, :func:`all_reduce_autograd` sums — and a parameter replicated
over the model axis gets its full gradient only once the ranks' parts
are summed (``train/loop.py::kfac_grads``).  Under this convention a
gather feeding a replicated consumer and one feeding a column-parallel
matmul need the same backward: the replicated consumer's copies each
carry a share, and their sum is what reaches the gathered input, so the
port has one gather and no gather whose backward slices.
:func:`all_reduce_max` (the vocabulary-parallel softmax's and the
flash-decoding combine's max) carries no gradient.
:func:`all_gather_coalesced` packs several tensors' gathers into one
collective, as :func:`all_reduce_coalesced` packs sums.
"""
from __future__ import annotations

from typing import Tuple, Union

import torch
import torch.distributed as dist


def backend_for(device: torch.device, world_size: int) -> str:
    """``gloo`` on the CPU or when ranks share a card, else ``nccl``."""
    if device.type != "cuda":
        return "gloo"
    if world_size > 1 and torch.cuda.device_count() < world_size:
        return "gloo"
    return "nccl"


Axes = Union[None, str, Tuple[str, ...]]


def all_gather(x: torch.Tensor, mesh, axis: Axes,
               dim: int = 0) -> torch.Tensor:
    """Every member's ``x`` concatenated along ``dim`` in the axis's
    coordinate order (``jax.lax.all_gather(x, axis, axis=dim,
    tiled=True)``; over a tuple of axes, row-major).  An axis of size 1
    (or None) returns ``x``."""
    if not isinstance(axis, str):
        for a in reversed(axis or ()):
            x = all_gather(x, mesh, a, dim)
        return x
    if mesh.shape[axis] == 1:
        return x
    if x.dtype == torch.bool:           # not every backend moves bools
        return all_gather(x.to(torch.uint8), mesh, axis, dim).bool()
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.shape[axis])]
    dist.all_gather(parts, x, group=mesh.group(axis))
    return torch.cat(parts, dim=dim)


def all_reduce(x: torch.Tensor, mesh, axis: Axes = None,
               op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``x`` reduced over ``axis`` (a name or a tuple of names; the whole
    mesh with ``axis=None``), in place and returned."""
    if isinstance(axis, tuple):
        for a in axis:
            all_reduce(x, mesh, a, op)
        return x
    if mesh.size == 1 or (axis is not None and mesh.shape[axis] == 1):
        return x
    dist.all_reduce(x, op=op, group=mesh.group(axis))
    return x


def all_reduce_coalesced(xs, mesh, axis: Axes = None,
                         bucket_bytes: int = 1 << 26) -> None:
    """Sum every tensor of ``xs`` over ``axis``, in place, packed into
    flat buffers of at most ``bucket_bytes`` (one collective a buffer
    instead of one a tensor; a larger tensor goes alone), in list order,
    so the ranks' buffers line up."""
    groups = {}
    for x in xs:
        groups.setdefault((x.dtype, x.device), []).append(x)
    for group in groups.values():
        bucket, size = [], 0
        for x in group + [None]:
            nbytes = 0 if x is None else x.numel() * x.element_size()
            if bucket and (x is None or size + nbytes > bucket_bytes):
                _reduce_bucket(bucket, mesh, axis)
                bucket, size = [], 0
            if x is not None:
                bucket.append(x)
                size += nbytes


def _reduce_bucket(bucket, mesh, axis) -> None:
    if len(bucket) == 1 and bucket[0].is_contiguous():
        all_reduce(bucket[0], mesh, axis)
        return
    flat = all_reduce(torch.cat([x.reshape(-1) for x in bucket]), mesh, axis)
    off = 0
    for x in bucket:
        x.copy_(flat[off:off + x.numel()].view_as(x))
        off += x.numel()


class _SumWithGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return all_reduce(x.clone(memory_format=torch.contiguous_format),
                          mesh, axis)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        return all_reduce(g, ctx.mesh, ctx.axis), None, None


def all_reduce_autograd(x: torch.Tensor, mesh, axis: Axes) -> torch.Tensor:
    """The sum of ``x`` over ``axis`` (out of place) whose backward sums
    the members' gradients over the same axes: every member's ``x`` gets
    the gradient of the sum of all members' losses."""
    return _SumWithGrad.apply(x, mesh, axis)


def all_reduce_max(x: torch.Tensor, mesh, axis: Axes) -> torch.Tensor:
    """The elementwise max of ``x`` over ``axis`` (out of place, no
    gradient)."""
    return all_reduce(x.detach().clone(memory_format=torch.contiguous_format),
                      mesh, axis, op=dist.ReduceOp.MAX)


def _block(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    n = mesh.shape[axis]
    size = x.shape[dim] // n
    return x.narrow(dim, mesh.coord(axis) * size, size)


def reduce_scatter(x: torch.Tensor, mesh, axis: str,
                   dim: int = 0) -> torch.Tensor:
    """``x`` summed over ``axis``, then this member's block along ``dim``
    (``jax.lax.psum_scatter(..., tiled=True)``): a sum and a slice, since
    gloo has no reduce-scatter; out of place."""
    if mesh.shape[axis] == 1:
        return x
    y = all_reduce(x.clone(memory_format=torch.contiguous_format), mesh,
                   axis)
    return _block(y, mesh, axis, dim).contiguous()


class _GatherGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return all_gather(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.mesh, ctx.axis, ctx.dim), None, None, None


class _ReduceScatterGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return reduce_scatter(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.mesh, ctx.axis, ctx.dim), None, None, None


def gather_grad(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """The members' ``x`` concatenated along ``dim``, differentiably: the
    backward sums the members' gradients of the whole and hands each its
    block (reduce-scatter), the adjoint under the port's convention (every
    member's loss a share of the global one)."""
    if mesh.shape[axis] == 1:
        return x
    return _GatherGrad.apply(x, mesh, axis, dim)


def reduce_scatter_grad(x: torch.Tensor, mesh, axis: str,
                        dim: int) -> torch.Tensor:
    """:func:`reduce_scatter`, differentiably: the backward gathers the
    members' gradients of their blocks."""
    if mesh.shape[axis] == 1:
        return x
    return _ReduceScatterGrad.apply(x, mesh, axis, dim)


def all_gather_coalesced(xs, mesh, axis: str, dims) -> list:
    """Each ``xs[i]`` gathered along ``dims[i]`` over ``axis`` (no
    gradient), the tensors of one dtype packed into one flat buffer and
    one collective."""
    n = mesh.shape[axis]
    if n == 1 or not xs:
        return list(xs)
    out = [None] * len(xs)
    groups = {}
    for i, x in enumerate(xs):
        groups.setdefault((x.dtype, x.device), []).append(i)
    for idx in groups.values():
        flat = torch.cat([xs[i].detach().reshape(-1) for i in idx])
        parts = [torch.empty_like(flat) for _ in range(n)]
        dist.all_gather(parts, flat, group=mesh.group(axis))
        off = 0
        for i in idx:
            x, k = xs[i], xs[i].numel()
            out[i] = torch.cat([p[off:off + k].view_as(x) for p in parts],
                               dim=dims[i])
            off += k
    return out
