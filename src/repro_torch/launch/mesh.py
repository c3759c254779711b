"""Meshes over ``torch.distributed``: one process is one mesh member.

Counterpart of ``src/repro/launch/mesh.py``.  A :class:`Mesh` wraps a
``torch.distributed.device_mesh.DeviceMesh`` over the first
``prod(shape)`` ranks of the world (``jax.make_mesh`` takes the first
``prod(shape)`` devices the same way, and raises when there are fewer)
and exposes what the reference's callers read of a ``jax.sharding.Mesh``:
``axis_names``, ``devices`` (the member ranks laid out in the mesh's
shape, so ``devices.shape`` and ``devices.size`` are the reference's),
plus each axis's process group and this rank's coordinate on it.

Building a mesh is collective: every rank of the world calls
:func:`make_mesh` with the same arguments (each axis's sub-groups are
created by all ranks); a rank outside the mesh gets one whose ``member``
is False.  A mesh is built once per world and shape: asking again (an
elastic runner returning to a rung) returns the same one, so process
groups, and their sockets, are not made anew.  At world size 1 with no
process group yet, :func:`make_mesh` sets up a one-member group itself
(a file store in a fresh temporary directory): ``nccl`` on the card,
``gloo`` on the CPU.

The world's backend is ``distributed/collectives.py::backend_for``'s
(``gloo`` on the CPU and for ranks sharing a card, else ``nccl``); the
collectives that run over a mesh's groups are in that module too.
"""
from __future__ import annotations

import datetime
import math
import os
import tempfile
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import device as device_lib
from repro_torch.distributed.collectives import backend_for

#: how long a collective may wait before its process group gives up
DEFAULT_TIMEOUT = datetime.timedelta(minutes=10)


def rank_device(device=None) -> torch.device:
    """This rank's device: the card unless the caller asks for another
    (a host without one raises); ranks beyond the card count share."""
    dev = device_lib.resolve(device)
    if dev.type == "cuda" and dev.index is None:
        local = int(os.environ.get("LOCAL_RANK",
                                   dist.get_rank() if dist.is_initialized()
                                   else 0))
        dev = torch.device("cuda", local % torch.cuda.device_count())
    return dev


def init_process_group(device=None, init_method: Optional[str] = None,
                       rank: Optional[int] = None,
                       world_size: Optional[int] = None,
                       timeout=DEFAULT_TIMEOUT) -> torch.device:
    """Join the world (``env://`` from ``torch.distributed.run`` unless
    ``init_method`` is given) with the backend :func:`backend_for` picks
    → this rank's device.  A no-op apart from the device when the world
    already exists."""
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", "1"))
    if rank is None:
        rank = int(os.environ.get("RANK", "0"))
    if not dist.is_initialized():
        dev = device_lib.resolve(device)
        if dev.type == "cuda" and dev.index is None:
            local = int(os.environ.get("LOCAL_RANK", rank))
            torch.cuda.set_device(local % torch.cuda.device_count())
        dist.init_process_group(backend_for(dev, world_size),
                                init_method=init_method or "env://",
                                rank=rank, world_size=world_size,
                                timeout=timeout)
    return rank_device(device)


def _init_single(device: torch.device) -> None:
    """A one-member world over a file store (no network)."""
    path = os.path.join(tempfile.mkdtemp(prefix="repro_mesh_"), "store")
    dist.init_process_group(backend_for(device, 1),
                            init_method=f"file://{path}", rank=0,
                            world_size=1, timeout=DEFAULT_TIMEOUT)


class Mesh:
    """A named mesh over ranks ``0 .. prod(shape) - 1`` of the world."""

    def __init__(self, shape: Tuple[int, ...], axes: Tuple[str, ...],
                 device: torch.device):
        self.axis_names = tuple(axes)
        self.devices = np.arange(math.prod(shape)).reshape(shape)
        self.device = device
        world = dist.get_world_size()
        n = self.devices.size
        dtype = "cuda" if device.type == "cuda" else "cpu"
        ranks = torch.arange(n).reshape(shape)
        if n == world:
            from torch.distributed.device_mesh import init_device_mesh
            self.device_mesh = init_device_mesh(
                dtype, tuple(shape), mesh_dim_names=self.axis_names)
            self._all = dist.group.WORLD
        else:
            from torch.distributed.device_mesh import DeviceMesh
            self.device_mesh = DeviceMesh(dtype, ranks,
                                          mesh_dim_names=self.axis_names)
            self._all = dist.new_group(list(range(n)))
        self.member = dist.get_rank() < n
        coord = self.device_mesh.get_coordinate() if self.member else None
        self._coord = dict(zip(self.axis_names, coord or ()))

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def coord(self, axis: str) -> int:
        """This rank's coordinate on ``axis``
        (``jax.lax.axis_index(axis)``)."""
        return int(self._coord[axis])

    def group(self, axis: Optional[str] = None):
        """The process group of ``axis`` this rank belongs to, or of the
        whole mesh with ``axis=None``."""
        if axis is None:
            return self._all
        return self.device_mesh.get_group(axis)

    def __repr__(self) -> str:
        dims = ", ".join(f"{a}={s}" for a, s in self.shape.items())
        return f"Mesh({dims}; {self.device})"


def make_mesh(shape: Sequence[int], axes: Sequence[str], device=None
              ) -> Mesh:
    """Arbitrary mesh (elastic fallback shapes, tests).  Raises
    ``ValueError`` when the world has fewer than ``prod(shape)`` ranks,
    as ``jax.make_mesh`` does with too few devices; takes the first
    ``prod(shape)`` ranks when it has more.  Collective: every rank of
    the world calls it."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} does not match axes {axes}")
    n = math.prod(shape)
    if not dist.is_initialized():
        if n > 1:
            raise ValueError(f"Number of ranks 1 must be >= the product "
                             f"of mesh_shape {shape}")
        _init_single(device_lib.resolve(device))
    world = dist.get_world_size()
    if n > world:
        raise ValueError(f"Number of ranks {world} must be >= the product "
                         f"of mesh_shape {shape}")
    dev = rank_device(device)
    key = (id(dist.group.WORLD), shape, axes, str(dev))
    if key not in _MESHES:
        _MESHES[key] = Mesh(shape, axes, dev)
    return _MESHES[key]


#: (world, shape, axes, device) → its Mesh
_MESHES: dict = {}


def make_production_mesh(*, multi_pod: bool = False, device=None) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device=device)


def data_axes(mesh) -> tuple:
    """All non-model axes (batch/token sharding)."""
    return tuple(a for a in mesh.axis_names if a != "model")
