"""Elastic scaling + failure handling, on ``torch.distributed``.

Counterpart of ``src/repro/train/elastic.py``.  The policy:

  1. every ``ckpt_every`` steps an AsyncCheckpointer snapshot is
     published (the state gathered to the one-device format; rank 0
     writes it);
  2. on failure, the runner drops one rung of the mesh ladder, rebuilds
     the shardings for it, and restores the newest healthy checkpoint
     with resharding (``train/checkpoint.py`` ``restore(shardings=…)``);
  3. the batch schedule is deterministic in the step, so the resumed run
     replays the exact stream;
  4. K-FAC factor states are checkpointed too, so a restart never loses
     curvature history.

A rung's mesh spans the first ``prod(shape)`` ranks of the world (the
surviving ones).  Building it is collective, so every rank builds every
rung; ranks outside it wait, and rank 0 tells all of them, after each
attempt, whether the run ended or which rung comes next.  A failure is a
``RuntimeError`` raised on every member at the same step — chaos's
``host_loss`` or :class:`FailureInjector`'s, both keyed on the step.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import torch.distributed as dist

from repro_torch.launch import mesh as mesh_lib
from repro_torch.train import checkpoint as ckpt_lib


def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def device_ladder(n_devices: Optional[int] = None,
                  axes: Tuple[str, ...] = ("data",),
                  shape: Optional[Tuple[int, ...]] = None
                  ) -> Tuple[Tuple[Tuple[int, ...], Tuple[str, ...]], ...]:
    """The recovery ladder from the ranks that actually exist (the world
    size, where the reference counts ``jax.devices()``): full capacity,
    then successive halvings down to one member.  Without ``shape`` the
    first axis absorbs the count and trailing axes get 1; with a starting
    ``shape`` each rung halves the *largest* dimension (ties break
    leftmost).  :func:`shrunk_axes` names which axis a transition
    shrank."""
    n = _world() if n_devices is None else int(n_devices)
    if shape is None:
        shape = (max(1, n),) + (1,) * (len(axes) - 1)
    shape = tuple(max(1, int(x)) for x in shape)
    if len(shape) != len(axes):
        raise ValueError(f"shape {shape} does not match axes {axes}")
    ladder = [(shape, tuple(axes))]
    while any(x > 1 for x in shape):
        i = max(range(len(shape)), key=lambda j: shape[j])
        shape = shape[:i] + (shape[i] // 2,) + shape[i + 1:]
        ladder.append((shape, tuple(axes)))
    return tuple(ladder)


def shrunk_axes(prev: Tuple[int, ...], cur: Tuple[int, ...],
                axes: Tuple[str, ...]) -> Tuple[str, ...]:
    """Names of the mesh axes that shrank between two ladder rungs."""
    return tuple(a for a, p, c in zip(axes, prev, cur) if c < p)


#: (mesh shape, axis names), largest first — a pinned recovery ladder;
#: :class:`ElasticRunner` defaults to :func:`device_ladder`.
FALLBACK_MESHES: Sequence[Tuple[Tuple[int, ...], Tuple[str, ...]]] = (
    ((2, 16, 16), ("pod", "data", "model")),
    ((16, 16), ("data", "model")),
    ((8, 16), ("data", "model")),
)


class FailureInjector:
    """Test hook: schedule step indices that raise a simulated fault."""

    def __init__(self, fail_at: Sequence[int] = ()):
        self.fail_at = set(fail_at)
        self.failed: List[int] = []

    def check(self, step: int):
        if step in self.fail_at:
            self.fail_at.discard(step)
            self.failed.append(step)
            raise RuntimeError(f"injected node failure at step {step}")


_DONE = -1


@dataclasses.dataclass
class ElasticRunner:
    """Drives train steps with checkpoint/restart + mesh fallback.

    make_state:   (mesh) -> state           (init or cold start)
    make_step:    (mesh) -> step_fn(state, step_idx) -> state
    state_shardings: (state_template, mesh) -> shardings tree for
                  ``distributed/sharding.py`` (restore, and the gather
                  before a save)

    ``meshes=None`` derives the ladder from the world
    (:func:`device_ladder`).  A ``writer`` (rank 0's) receives a
    ``repartition`` event per mesh change (with ``axis`` on a shrink of a
    multi-axis rung) and a stage-4 ``remediation`` event per restart.
    Restores go through ``restore_latest_healthy``.  ``device`` is the
    members' device (the card unless asked).  Every rank of the world
    calls :meth:`run`; a rank outside the final mesh returns None for
    the state."""
    ckpt_dir: str
    make_state: Callable
    make_step: Callable
    state_shardings: Optional[Callable] = None
    ckpt_every: int = 10
    keep: int = 2
    meshes: Optional[Sequence] = None
    injector: Optional[FailureInjector] = None
    writer: Optional[object] = None
    device: Optional[object] = None

    def _ladder(self) -> Sequence:
        return self.meshes if self.meshes is not None else device_ladder()

    def _emit(self, etype: str, **fields):
        if self.writer is not None and (not dist.is_initialized()
                                        or dist.get_rank() == 0):
            self.writer.emit(etype, **fields)

    def run(self, n_steps: int, start_mesh_idx: int = 0) -> Tuple:
        ladder = self._ladder()
        mesh_idx = start_mesh_idx
        restarts = 0
        state = None
        while True:
            mesh = self._make_mesh(ladder, mesh_idx)
            nxt = _DONE
            if mesh.member:
                state, nxt, restarts = self._attempt(ladder, mesh_idx,
                                                     mesh, n_steps,
                                                     restarts)
            # rank 0 tells every rank (members and waiting ones) what next
            nxt = self._broadcast(mesh, (nxt, restarts))
            nxt, restarts = nxt
            if nxt == _DONE:
                return (state if mesh.member else None), {
                    "restarts": restarts, "mesh_idx": mesh_idx}
            mesh_idx = nxt

    def _attempt(self, ladder, mesh_idx, mesh, n_steps, restarts):
        """One rung: restore or init, step until the end or a failure →
        (state, next rung or _DONE, restarts)."""
        state = self._restore_or_init(mesh)
        step_fn = self.make_step(mesh)
        start = ckpt_lib.latest_step(self.ckpt_dir)
        k0 = 0 if start is None else start + 1
        mesh_desc = dict(zip(mesh.axis_names,
                             (int(s) for s in mesh.devices.shape)))
        extra = {}
        if 0 < mesh_idx < len(ladder):
            p_shape, p_axes = ladder[mesh_idx - 1]
            c_shape, c_axes = ladder[mesh_idx]
            if p_axes == c_axes and len(p_shape) == len(c_shape):
                ax = shrunk_axes(tuple(p_shape), tuple(c_shape),
                                 tuple(c_axes))
                if ax:
                    extra["axis"] = ",".join(ax)
        self._emit("repartition",
                   detail=f"mesh {mesh_desc} ({mesh.devices.size} "
                          f"devices), resuming at step {k0}", **extra)
        rank0 = dist.get_rank() == 0
        ck = (ckpt_lib.AsyncCheckpointer(self.ckpt_dir, keep=self.keep)
              if rank0 else None)
        sh = self._shardings(state, mesh)
        try:
            for k in range(k0, n_steps):
                if self.injector is not None:
                    self.injector.check(k)
                state = step_fn(state, k)
                if k % self.ckpt_every == 0:
                    self._submit(ck, k, state, sh, mesh_idx)
            if ck is not None:
                ck.close()
            return state, _DONE, restarts
        except RuntimeError as e:
            # failure: drop to the next smaller healthy mesh and resume
            if ck is not None:
                try:
                    ck.wait()
                    ck.close()
                except RuntimeError:
                    pass        # torn async write; restore walks past it
            restarts += 1
            self._emit("remediation", step=0, stage=4,
                       action="repartition",
                       detail=f"restart #{restarts} after {e}; "
                              f"falling back down the mesh ladder")
            return state, min(mesh_idx + 1, len(ladder) - 1), restarts

    def _submit(self, ck, k, state, sh, mesh_idx) -> None:
        """Gather to the one-device format (collective), rank 0 writes."""
        from repro_torch.distributed import sharding as shd
        tree = shd.globalize(state, sh) if sh is not None else state
        if ck is not None:
            ck.submit(k, tree, extra={"mesh_idx": mesh_idx})

    def _broadcast(self, mesh, value):
        if not dist.is_initialized() or dist.get_world_size() == 1:
            return value
        box = [value]
        dist.broadcast_object_list(box, src=0)
        return box[0]

    def _make_mesh(self, ladder, idx: int):
        shape, axes = ladder[idx]
        try:
            return mesh_lib.make_mesh(shape, axes, device=self.device)
        except ValueError:
            # the world is too small for this rung: shrink to one member
            return mesh_lib.make_mesh((1,) * len(axes), axes,
                                      device=self.device)

    def _shardings(self, template, mesh):
        return (self.state_shardings(template, mesh)
                if self.state_shardings else None)

    def _restore_or_init(self, mesh):
        template = self.make_state(mesh)
        step = ckpt_lib.latest_step(self.ckpt_dir)
        if step is None:
            return template
        try:
            state, _ = ckpt_lib.restore_latest_healthy(
                self.ckpt_dir, template,
                shardings=self._shardings(template, mesh))
        except FileNotFoundError:
            return template
        return state
