"""EA K-factor SYRK update on the card:  out = keep·M + coef·X Xᵀ.

Counterpart of ``src/repro/kernels/ea_syrk.py`` (Pallas,
``ea_syrk_batched_pallas``); the kernel is ``csrc/ea_syrk.cu``, on the
3xTF32 tensor-core mainloop of ``csrc/tc_gemm.cuh`` (one triangle of
X Xᵀ; a row block of it where a rank holds a factor's rows), and its
plain version ``ref.ea_syrk``.  CUDA tensors only —
``ops.ea_syrk`` dispatches and sends CPU tensors to the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build as B

KERNEL = B.Kernel("ea_syrk", "kfk_ea_syrk",
                  [B.P, B.L, B.L, B.P, B.L, B.L, B.P, B.L, B.L, B.P, B.P,
                   B.P, B.I, B.I, B.I, B.I, B.F, B.F, B.I, B.I])


def ea_syrk_batched(M: torch.Tensor, X: torch.Tensor, keep: float,
                    coef: float, X_rows: torch.Tensor = None
                    ) -> torch.Tensor:
    """M: (B, d, d), X: (B, d, n) fp32 CUDA → (B, d, d).  One launch,
    bitwise the same from run to run; M need not be symmetric.

    With ``X_rows`` (B, rb, n), a row block of X (a view of its rows
    [r0, r0+rb) keeps X's strides), M is the same rows of the factor,
    (B, rb, d), and the launch gives keep·M + coef·X_rows Xᵀ (B, rb, d)."""
    batch, d, n = X.shape
    Xr = X if X_rows is None else X_rows
    rows = Xr.shape[1]
    B.check_stack("ea_syrk", batch, M=M, X=X, X_rows=Xr)
    B.check_shape("ea_syrk", "M", M, (batch, rows, d))
    B.check_shape("ea_syrk", "X_rows", Xr, (batch, rows, n))
    out = torch.empty((batch, rows, d), device=X.device, dtype=torch.float32)
    ws, counters, splits, cluster = B.tc_launch_args(
        rows, d, n, batch, X, sym=X_rows is None)
    KERNEL(*B.mat_args(M), *B.mat_args(Xr), *B.mat_args(X), B.ptr(out), ws,
           counters, batch, rows, d, n, float(keep), float(coef), splits,
           cluster)
    return out
