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
collective, as :func:`all_reduce_coalesced` packs sums; the factor rows
on the model axis (``sharding.RowBlock``) use both: a precondition
bucket's panels are summed in one call, and the U row blocks its steps
need whole are gathered in one.

**Counting.**  While a :func:`counting` block runs, every collective of
this module records what this process moved into the yielded
:class:`Tally`, the backward passes of the autograd forms included (they
call the same functions).  A call is counted once, at the outermost
counted function: a collective made inside another counted one (the sum
under :func:`reduce_scatter`, the per-axis calls of a whole-mesh tuple)
counts only in that one, and a tuple naming some but not every axis of
the mesh counts as its per-axis calls.  Each call is kept three ways:
the bytes handed in and the calls under the port's function name
(``all_gather``, ``all_reduce``, ``all_reduce_coalesced`` a packed
buffer, ``reduce_scatter``, ``all_gather_coalesced``,
``reduce_scatter_coalesced``; a call on a group of one member counts
too); the reference's convention (``launch/hlo_analysis.py``'s parser of
the optimized HLO) under its kind names, where an all-gather counts its
output, an all-reduce its tensor and a reduce-scatter its operand (gloo's
sum and slice is the logical reduce-scatter), and a group of one member
moves nothing; and those bytes by the axis or axes the call ran over.
Counting reads only shapes: it adds no device synchronisation.
"""
from __future__ import annotations

import contextlib
import functools
import math
import threading
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


def _whole_mesh(mesh, axis) -> bool:
    """Whether ``axis`` is a tuple naming every axis of ``mesh`` in its
    order: its members are the whole mesh's group, ranked row-major."""
    return (isinstance(axis, tuple) and len(axis) > 1
            and axis == tuple(mesh.axis_names))


def group_of(mesh, axis):
    """(process group, members, this rank's index among them) of a single
    axis, or of every axis at once (a tuple naming all of them: one
    collective over the whole mesh instead of one an axis)."""
    if _whole_mesh(mesh, axis):
        idx = 0
        for a in mesh.axis_names:
            idx = idx * mesh.shape[a] + mesh.coord(a)
        return mesh.group(None), mesh.size, idx
    return mesh.group(axis), mesh.shape[axis], mesh.coord(axis)


def _members(mesh, axis) -> int:
    return mesh.size if _whole_mesh(mesh, axis) else mesh.shape[axis]


#: the reference's collective kinds (``launch/hlo_analysis.py``)
KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
         "collective-permute")


class Tally:
    """What the collectives of a :func:`counting` block moved.
    ``by_name``: port function → [bytes handed in, calls]; ``by_kind``:
    the reference's ``collective_bytes`` breakdown (each kind's bytes and
    its ``<kind>_count``); ``by_axis``: the axis or axes ("data",
    "pod+data") → the reference-convention bytes."""

    def __init__(self, on_call=None):
        self.by_name = {}
        self.by_kind = {k: 0 for k in KINDS}
        self.by_kind.update({k + "_count": 0 for k in KINDS})
        self.by_axis = {}
        self.on_call = on_call

    @property
    def total(self) -> int:
        """The reference convention's total bytes."""
        return sum(self.by_kind[k] for k in KINDS)

    def record(self, name: str, kind: str, handed: int, members: int,
               axis_tag: str) -> None:
        row = self.by_name.setdefault(name, [0, 0])
        row[0] += handed
        row[1] += 1
        if members > 1:
            moved = handed * members if kind == "all-gather" else handed
            self.by_kind[kind] += moved
            self.by_kind[kind + "_count"] += 1
            self.by_axis[axis_tag] = self.by_axis.get(axis_tag, 0) + moved


#: the tallies of the open :func:`counting` blocks (innermost last)
_TALLIES: list = []
#: how deep this thread is inside counted calls
_DEPTH = threading.local()


@contextlib.contextmanager
def counting(on_call=None):
    """Count every collective of this module while the block runs → the
    :class:`Tally` (module docstring).  ``on_call(name)``, when given, is
    a context manager entered around each counted call (outermost only;
    the tally holds the call when it exits): a caller's own timing."""
    tally = Tally(on_call)
    _TALLIES.append(tally)
    try:
        yield tally
    finally:
        _TALLIES.remove(tally)


def _axis_tag(mesh, axis) -> str:
    if axis is None:
        return "+".join(mesh.axis_names)
    return axis if isinstance(axis, str) else "+".join(axis)


def _counted(kind: str, name: str = ""):
    """Count a collective ``fn(x, mesh, axis, ...)`` of ``kind`` (the
    reference's) under ``name`` (default: its own) in the open tallies."""
    def wrap(fn):
        label = name or fn.__name__

        @functools.wraps(fn)
        def counted(x, mesh, axis=None, *a, **kw):
            if (not _TALLIES or getattr(_DEPTH, "n", 0)
                    or (isinstance(axis, tuple)
                        and sum_axes(mesh, axis) is not None)):
                return fn(x, mesh, axis, *a, **kw)
            xs = x if isinstance(x, (list, tuple)) else [x]
            handed = sum(t.numel() * t.element_size() for t in xs)
            members = (mesh.size if axis is None or _whole_mesh(mesh, axis)
                       else mesh.shape[axis])
            tallies = list(_TALLIES)
            _DEPTH.n = 1
            try:
                with contextlib.ExitStack() as hooks:
                    for t in tallies:
                        if t.on_call is not None:
                            hooks.enter_context(t.on_call(label))
                    out = fn(x, mesh, axis, *a, **kw)
                    for t in tallies:
                        t.record(label, kind, handed, members,
                                 _axis_tag(mesh, axis))
            finally:
                _DEPTH.n = 0
            return out
        return counted
    return wrap


@_counted("all-gather")
def all_gather(x: torch.Tensor, mesh, axis: Axes,
               dim: int = 0) -> torch.Tensor:
    """Every member's ``x`` concatenated along ``dim`` in the axis's
    coordinate order (``jax.lax.all_gather(x, axis, axis=dim,
    tiled=True)``; over a tuple of axes, row-major: one collective when
    the tuple is every axis of the mesh).  An axis of size 1 (or None)
    returns ``x``."""
    if not isinstance(axis, str) and not _whole_mesh(mesh, axis):
        for a in reversed(axis or ()):
            x = all_gather(x, mesh, a, dim)
        return x
    if _members(mesh, axis) == 1:
        return x
    if x.dtype == torch.bool:           # not every backend moves bools
        return all_gather(x.to(torch.uint8), mesh, axis, dim).bool()
    x = x.contiguous()
    group, n, _ = group_of(mesh, axis)
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


@_counted("all-reduce")
def all_reduce(x: torch.Tensor, mesh, axis: Axes = None,
               op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``x`` reduced over ``axis`` (a name or a tuple of names; the whole
    mesh with ``axis=None``, in one collective), in place and
    returned."""
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


@_counted("all-reduce", name="all_reduce_coalesced")
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


def _block(x: torch.Tensor, mesh, axis, dim: int) -> torch.Tensor:
    _, n, idx = group_of(mesh, axis)
    size = x.shape[dim] // n
    return x.narrow(dim, idx * size, size)


def sum_axes(mesh, axis) -> Axes:
    """What :func:`all_reduce` takes to sum over ``axis`` in one
    collective: None (the whole mesh) for a tuple naming every axis of
    the mesh, else ``axis``."""
    return None if _whole_mesh(mesh, axis) else axis


def _sum_over(x: torch.Tensor, mesh, axis) -> torch.Tensor:
    return all_reduce(x, mesh, sum_axes(mesh, axis))


@_counted("reduce-scatter")
def reduce_scatter(x: torch.Tensor, mesh, axis,
                   dim: int = 0) -> torch.Tensor:
    """``x`` summed over ``axis`` (one axis, or a tuple naming every axis
    of the mesh), then this member's block along ``dim``
    (``jax.lax.psum_scatter(..., tiled=True)``): a sum and a slice, since
    gloo has no reduce-scatter; out of place."""
    if _members(mesh, axis) == 1:
        return x
    y = _sum_over(x.clone(memory_format=torch.contiguous_format), mesh,
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


def gather_grad(x: torch.Tensor, mesh, axis, dim: int) -> torch.Tensor:
    """The members' ``x`` concatenated along ``dim``, differentiably: the
    backward sums the members' gradients of the whole and hands each its
    block (reduce-scatter), the adjoint under the port's convention (every
    member's loss a share of the global one).  ``axis``: one axis, or a
    tuple naming every axis of the mesh (one collective each way)."""
    if _members(mesh, axis) == 1:
        return x
    return _GatherGrad.apply(x, mesh, axis, dim)


def reduce_scatter_grad(x: torch.Tensor, mesh, axis: str,
                        dim: int) -> torch.Tensor:
    """:func:`reduce_scatter`, differentiably: the backward gathers the
    members' gradients of their blocks."""
    if mesh.shape[axis] == 1:
        return x
    return _ReduceScatterGrad.apply(x, mesh, axis, dim)


@_counted("all-gather")
def all_gather_coalesced(xs, mesh, axis, dims) -> list:
    """Each ``xs[i]`` gathered along ``dims[i]`` over ``axis`` (one axis,
    or a tuple naming every axis of the mesh; no gradient), the tensors
    of one dtype packed into one flat buffer and one collective."""
    n = _members(mesh, axis)
    if n == 1 or not xs:
        return list(xs)
    group = group_of(mesh, axis)[0]
    out = [None] * len(xs)
    groups = {}
    for i, x in enumerate(xs):
        groups.setdefault((x.dtype, x.device), []).append(i)
    for idx in groups.values():
        flat = torch.cat([xs[i].detach().reshape(-1) for i in idx])
        parts = [torch.empty_like(flat) for _ in range(n)]
        dist.all_gather(parts, flat, group=group)
        off = 0
        for i in idx:
            x, k = xs[i], xs[i].numel()
            out[i] = torch.cat([p[off:off + k].view_as(x) for p in parts],
                               dim=dims[i])
            off += k
    return out


@_counted("reduce-scatter")
def reduce_scatter_coalesced(xs, mesh, axis, dims) -> list:
    """Each ``xs[i]`` summed over ``axis`` (as :func:`all_gather_coalesced`
    takes it), then this member's block along ``dims[i]``: the tensors of
    one dtype laid out member-major (every member's blocks of all of them
    in turn) in one flat buffer, summed in one collective, and this
    member's stretch split back (gloo has no reduce-scatter)."""
    _, n, me = group_of(mesh, axis) if xs else (None, 1, 0)
    if n == 1 or not xs:
        return list(xs)
    out = [None] * len(xs)
    groups = {}
    for i, x in enumerate(xs):
        groups.setdefault((x.dtype, x.device), []).append(i)
    for idx in groups.values():
        sizes = [xs[i].shape[dims[i]] // n for i in idx]
        flat = torch.cat([xs[i].detach().narrow(dims[i], j * s, s)
                          .reshape(-1)
                          for j in range(n) for i, s in zip(idx, sizes)])
        _sum_over(flat, mesh, axis)
        # this member's stretch copied out, so the whole buffer goes now
        part = flat.numel() // n
        mine = flat[part * me:part * (me + 1)].clone()
        del flat
        off = 0
        for i, s in zip(idx, sizes):
            shape = list(xs[i].shape)
            shape[dims[i]] = s
            k = math.prod(shape)
            out[i] = mine[off:off + k].view(shape)
            off += k
    return out


class _GatherCoalescedGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, axis, dims, *xs):
        ctx.mesh, ctx.axis, ctx.dims = mesh, axis, dims
        return tuple(all_gather_coalesced(list(xs), mesh, axis, dims))

    @staticmethod
    def backward(ctx, *gs):
        return (None, None, None) + tuple(reduce_scatter_coalesced(
            list(gs), ctx.mesh, ctx.axis, ctx.dims))


def gather_grad_coalesced(xs, mesh, axis, dims) -> list:
    """:func:`gather_grad` of each ``xs[i]`` along ``dims[i]``, packed: one
    gather forward (:func:`all_gather_coalesced`) and one reduce-scatter
    backward (:func:`reduce_scatter_coalesced`) for all of them."""
    if _members(mesh, axis) == 1 or not xs:
        return list(xs)
    return list(_GatherCoalescedGrad.apply(mesh, axis, tuple(dims), *xs))
