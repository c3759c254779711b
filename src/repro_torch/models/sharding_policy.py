"""Activation-sharding policy threaded through the models.

Counterpart of ``src/repro/models/sharding_policy.py``: the same policy
fields and activation roles, so the models call the reference's methods
at the reference's places.  Every role is the identity: on a mesh of
data and curvature axes each rank runs the whole batch's forward and
backward (only the factor work shards, ``distributed/curvature.py``), so
the activations are those of one device.  A model axis larger than 1
would need tensor-parallel execution, which the port does not have
(ROADMAP §1 item 6): every role then raises.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

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

    @property
    def active(self) -> bool:
        return bool(self.dp) or self.tp is not None

    @property
    def model_parallel(self) -> bool:
        """True iff the policy shards over a model axis larger than 1."""
        return self.tp is not None and dict(self.axis_sizes).get(
            self.tp, 1) > 1

    def _c(self, x: Tensor) -> Tensor:
        if self.model_parallel:
            raise NotImplementedError(
                "a model axis larger than 1 needs tensor-parallel "
                "execution, which is not ported (ROADMAP §1 item 6, "
                "'Data- and tensor-parallel execution'); use a mesh of "
                "data and curvature axes")
        return x

    # --- activation roles (the identity on one device) ---------------------
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
