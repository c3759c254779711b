"""Low-rank inverse application on the card:  Y = (X U) diag(s) Uᵀ + X/λ.

Counterpart of ``src/repro/kernels/lowrank_apply.py`` (Pallas,
``lowrank_apply_batched_pallas``: stage A ``_xu_kernel``, stage B
``_tut_kernel``); the kernel is ``csrc/lowrank_apply.cu``, two products on
the 3xTF32 tensor-core mainloop of ``csrc/tc_gemm.cuh``, and its plain
version ``ref.lowrank_apply``.  X comes with contiguous rows, or as the
transposed view of a stack with contiguous rows (the left application's
operand, :func:`columns`); then the kernel reads it as it lies and Y comes
back the same way, a transposed view of a contiguous (B, d, p).  The first
product writes its (p, w) or (w, p) result to a workspace allocated here,
as the TPU's stage A writes T to memory.  CUDA tensors only —
``ops.lowrank_apply`` dispatches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build as B

#: after the operands and the layout flag, (workspace, counters, splits,
#: cluster) of each of the two products (``_build.tc_launch_args``)
KERNEL = B.Kernel("lowrank_apply", "kfk_lowrank_apply",
                  [B.P, B.L, B.L, B.P, B.L, B.L, B.P, B.L, B.P, B.I, B.P,
                   B.P] + 2 * [B.P, B.P, B.I, B.I] + [B.I, B.I, B.I, B.I])


def columns(X: torch.Tensor) -> bool:
    """Whether X (…, p, d) is the transpose of a (…, d, p) with contiguous
    rows and not itself row-contiguous: the layout the kernel takes as
    columns, without a copy."""
    return X.shape[-1] > 1 and X.stride(-1) != 1 and X.stride(-2) == 1


def lowrank_apply_batched(X: torch.Tensor, U: torch.Tensor, s: torch.Tensor,
                          ilam: torch.Tensor) -> torch.Tensor:
    """X: (B, p, d) with contiguous rows or columns, U: (B, d, w),
    s: (B, w), ilam: (B,) = 1/λ per element → (B, p, d), laid out as X
    (rows: contiguous; columns: the transposed view of a contiguous
    (B, d, p))."""
    batch, p, d = X.shape
    w = U.shape[-1]
    cols = columns(X)
    Xs = X.mT if cols else X          # the operand as stored
    B.check_stack("lowrank_apply", batch, X=Xs, U=U)
    B.check_shape("lowrank_apply", "U", U, (batch, d, w))
    B.check_vec("lowrank_apply", batch, w, s=s)
    B.check_vec("lowrank_apply", 1, batch, ilam=ilam.reshape(1, -1))
    dev = X.device
    # outputs before the plans: a plan's split-K workspace is freed on
    # return, and only later allocations on the stream may take it again
    if cols:
        T = torch.empty((batch, w, p), device=dev, dtype=torch.float32)
        Y = torch.empty((batch, d, p), device=dev, dtype=torch.float32)
        plans = (B.tc_launch_args(w, p, d, batch, X)     # C = diag(s) Uᵀ Z
                 + B.tc_launch_args(d, p, w, batch, X))  # Yᵀ = U C + Z/λ
    else:
        T = torch.empty((batch, p, w), device=dev, dtype=torch.float32)
        Y = torch.empty((batch, p, d), device=dev, dtype=torch.float32)
        plans = (B.tc_launch_args(p, w, d, batch, X)     # T = (X U) diag(s)
                 + B.tc_launch_args(p, d, w, batch, X))  # Y = T Uᵀ + X/λ
    KERNEL(*B.mat_args(Xs), *B.mat_args(U), B.ptr(s), s.stride(0),
           B.ptr(ilam), int(cols), B.ptr(T), B.ptr(Y), *plans, batch, p, d,
           w)
    return Y.mT if cols else Y
