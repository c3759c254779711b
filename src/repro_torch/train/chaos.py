"""Deterministic seed-driven fault injection for the training stack.

Counterpart of ``src/repro/train/chaos.py``: the same fault kinds, plans
and hooks, on the port's tensors and runner.

  ``nan_grad``          — poison the batch with NaN so the backward pass
                          produces nonfinite grads (stage-0 skip, then
                          damping escalation / forced refresh).
  ``corrupt_inflight``  — overwrite the in-flight snapshot buffers with
                          NaN and force their ``live`` flags on, so the
                          next scheduled landing tries to swap poison in.
  ``drop_landing``      — discard the async runner's pending futures: the
                          landing falls back to the in-line heavy op from
                          the same snapshot (same numbers).
  ``hang_landing``      — replace pending futures with never-completing
                          ones: exercises the landing deadline.
  ``worker_death``      — replace pending futures with ones that raise:
                          exercises the crash-miss path + pool respawn.
  ``host_loss``         — raise ``RuntimeError`` out of the step loop.
                          The reference's elastic mesh ladder that
                          catches it is not ported yet (ROADMAP, module
                          item "Distributed").
  ``truncate_ckpt``     — truncate the newest snapshot's array file on
                          disk: exercises checksum verification and
                          ``restore_latest_healthy``'s ring walk.

Plans are explicit (a tuple of :class:`Fault`) or derived from a seed via
:meth:`ChaosMonkey.from_seed` — ``numpy.random.default_rng`` only, so a
plan is a pure function of ``(seed, n_steps, kinds)`` and equals the
reference's for the same arguments.  Everything injected is recorded in
``self.injected``.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

KINDS = ("nan_grad", "corrupt_inflight", "drop_landing", "hang_landing",
         "worker_death", "host_loss", "truncate_ckpt")


@dataclasses.dataclass(frozen=True)
class Fault:
    step: int
    kind: str

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"expected one of {KINDS}")


class _DeadFuture:
    """Stand-in for a future whose worker thread died: ``.result``
    raises immediately, whatever the timeout."""

    def result(self, timeout=None):
        raise RuntimeError("chaos: injected worker death")

    def done(self):
        return True

    def cancel(self):
        return True


def _hung_future():
    # a bare, never-completed Future: ``.result(timeout)`` raises
    # TimeoutError after the deadline
    return concurrent.futures.Future()


def _nan_like(x):
    if isinstance(x, torch.Tensor) and x.is_floating_point():
        return torch.full_like(x, float("nan"))
    return x


class ChaosMonkey:
    """Deterministic fault injector; the hooks are called by the trainer
    (``loop.run_kfac_training``) and by tests.  Every hook is a no-op
    unless the plan names a fault for that step."""

    def __init__(self, faults: Sequence[Fault] = ()):
        self.faults: Tuple[Fault, ...] = tuple(faults)
        self.injected: List[Tuple[int, str]] = []

    @classmethod
    def from_seed(cls, seed: int, n_steps: int,
                  kinds: Sequence[str] = ("nan_grad",),
                  n_faults: int = 3, first: int = 1) -> "ChaosMonkey":
        """A reproducible plan: ``n_faults`` distinct steps in
        ``[first, n_steps)``, kinds drawn uniformly from ``kinds``."""
        rng = np.random.default_rng(seed)
        lo, hi = int(first), int(n_steps)
        if hi <= lo:
            return cls(())
        steps = rng.choice(np.arange(lo, hi),
                           size=min(int(n_faults), hi - lo),
                           replace=False)
        picks = rng.choice(np.asarray(list(kinds)), size=len(steps))
        return cls(tuple(Fault(int(s), str(k))
                         for s, k in sorted(zip(steps, picks))))

    # -- plan queries -------------------------------------------------------
    def _hits(self, step: int, kind: str) -> bool:
        return any(f.step == step and f.kind == kind for f in self.faults)

    def _mark(self, step: int, kind: str) -> None:
        self.injected.append((int(step), kind))

    # -- data-path hooks ----------------------------------------------------
    def corrupt_batch(self, step: int, batch):
        """``nan_grad``: fill every floating tensor of the batch (a tuple or
        list of tensors, or one tensor) with NaN; integer labels stay."""
        if not self._hits(step, "nan_grad"):
            return batch
        self._mark(step, "nan_grad")
        if isinstance(batch, (tuple, list)):
            return type(batch)(_nan_like(v) for v in batch)
        return _nan_like(batch)

    def corrupt_state(self, step: int, state):
        """``corrupt_inflight``: NaN out every in-flight snapshot buffer
        and force its live flags on."""
        if not self._hits(step, "corrupt_inflight"):
            return state
        opt_state = getattr(state, "opt", state)
        if not opt_state.inflight:
            return state
        self._mark(step, "corrupt_inflight")
        nan = lambda t: torch.full_like(t, float("nan"))
        inflight = {
            key: dataclasses.replace(
                buf, U=nan(buf.U), D=nan(buf.D), M=nan(buf.M),
                live=torch.ones_like(buf.live))
            for key, buf in opt_state.inflight.items()}
        opt_state = dataclasses.replace(opt_state, inflight=inflight)
        if not hasattr(state, "opt"):
            return opt_state
        return dataclasses.replace(state, opt=opt_state)

    # -- async-runner hooks -------------------------------------------------
    def harass_runner(self, step: int, runner) -> None:
        """Apply ``drop_landing`` / ``hang_landing`` / ``worker_death``
        to an ``AsyncInverseRunner``'s pending futures (call *before*
        ``runner.landing``)."""
        if runner is None:
            return
        if self._hits(step, "drop_landing") and runner._pending:
            self._mark(step, "drop_landing")
            runner.drop_pending(reason="dropped")
        if self._hits(step, "hang_landing") and runner._pending:
            self._mark(step, "hang_landing")
            for key in list(runner._pending):
                runner._pending[key] = _hung_future()
        if self._hits(step, "worker_death") and runner._pending:
            self._mark(step, "worker_death")
            for key in list(runner._pending):
                runner._pending[key] = _DeadFuture()

    # -- host / disk hooks --------------------------------------------------
    def check(self, step: int) -> None:
        """``host_loss``: raise out of the step loop."""
        if self._hits(step, "host_loss"):
            self._mark(step, "host_loss")
            raise RuntimeError(f"injected node failure at step {step}")

    def corrupt_ckpt(self, step: int, directory: Optional[str]) -> None:
        """``truncate_ckpt``: truncate the newest snapshot's array file
        in ``directory`` to half its size (a torn write)."""
        if directory is None or not self._hits(step, "truncate_ckpt"):
            return
        if truncate_latest(directory):
            self._mark(step, "truncate_ckpt")

    # -- bookkeeping --------------------------------------------------------
    def summary(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for _, kind in self.injected:
            out[kind] = out.get(kind, 0) + 1
        return out


def truncate_latest(directory: str) -> bool:
    """Truncate the newest checkpoint's ``arrays.npz`` to half its size
    (a torn write).  Returns True if a file was truncated."""
    from repro_torch.train import checkpoint as ckpt_lib
    step = ckpt_lib.latest_step(directory)
    if step is None:
        return False
    path = os.path.join(directory, ckpt_lib._step_dir(step), "arrays.npz")
    if not os.path.exists(path):
        return False
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.truncate(max(1, size // 2))
    return True
