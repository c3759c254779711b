"""Low-rank inverse application on the card:  Y = (X U) diag(s) Uᵀ + X/λ.

Counterpart of ``src/repro/kernels/lowrank_apply.py`` (Pallas,
``lowrank_apply_batched_pallas``: stage A ``_xu_kernel``, stage B
``_tut_kernel``); the kernel is ``csrc/lowrank_apply.cu`` and its plain
version ``ref.lowrank_apply``.  Stage A writes T = (X U) diag(s) to a
workspace allocated here, as the TPU's stage A writes it to memory.
CUDA tensors only — ``ops.lowrank_apply`` dispatches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build as B

KERNEL = B.Kernel("lowrank_apply", "kfk_lowrank_apply",
                  [B.P, B.L, B.L, B.P, B.L, B.L, B.P, B.L, B.P, B.P, B.P,
                   B.P, B.I, B.I, B.I, B.I, B.I])


def lowrank_apply_batched(X: torch.Tensor, U: torch.Tensor, s: torch.Tensor,
                          ilam: torch.Tensor) -> torch.Tensor:
    """X: (B, p, d), U: (B, d, w), s: (B, w), ilam: (B,) = 1/λ per
    element → (B, p, d)."""
    batch, p, d = X.shape
    w = U.shape[-1]
    B.check_stack("lowrank_apply", batch, X=X, U=U)
    B.check_shape("lowrank_apply", "U", U, (batch, d, w))
    B.check_vec("lowrank_apply", batch, w, s=s)
    B.check_vec("lowrank_apply", 1, batch, ilam=ilam.reshape(1, -1))
    dev = X.device
    T = torch.empty((batch, p, w), device=dev, dtype=torch.float32)
    Y = torch.empty((batch, p, d), device=dev, dtype=torch.float32)
    splits = B.split_k(p, w, d, batch)
    ws = B.workspace(splits, batch, p, w, X)
    KERNEL(*B.mat_args(X), *B.mat_args(U), B.ptr(s), B.L(s.stride(0)),
           B.ptr(ilam), B.ptr(T), B.ptr(ws), B.ptr(Y), batch, p, d, w,
           splits)
    return Y
