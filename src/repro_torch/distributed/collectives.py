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
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist


def backend_for(device: torch.device, world_size: int) -> str:
    """``gloo`` on the CPU or when ranks share a card, else ``nccl``."""
    if device.type != "cuda":
        return "gloo"
    if world_size > 1 and torch.cuda.device_count() < world_size:
        return "gloo"
    return "nccl"


def all_gather(x: torch.Tensor, mesh, axis: Optional[str],
               dim: int = 0) -> torch.Tensor:
    """Every member's ``x`` concatenated along ``dim`` in the axis's
    coordinate order (``jax.lax.all_gather(x, axis, axis=dim,
    tiled=True)``).  An axis of size 1 (or None) returns ``x``."""
    if axis is None or mesh.shape[axis] == 1:
        return x
    if x.dtype == torch.bool:           # not every backend moves bools
        return all_gather(x.to(torch.uint8), mesh, axis, dim).bool()
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.shape[axis])]
    dist.all_gather(parts, x, group=mesh.group(axis))
    return torch.cat(parts, dim=dim)


def all_reduce(x: torch.Tensor, mesh, axis: Optional[str] = None,
               op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``x`` reduced over ``axis`` (the whole mesh with ``axis=None``), in
    place and returned."""
    if mesh.size == 1 or (axis is not None and mesh.shape[axis] == 1):
        return x
    dist.all_reduce(x, op=op, group=mesh.group(axis))
    return x
