"""EA K-factor SYRK update on the card:  out = keep·M + coef·X Xᵀ.

Counterpart of ``src/repro/kernels/ea_syrk.py`` (Pallas,
``ea_syrk_batched_pallas``); the kernel is ``csrc/ea_syrk.cu`` and its
plain version ``ref.ea_syrk``.  CUDA tensors only — ``ops.ea_syrk``
dispatches and sends CPU tensors to the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build as B

KERNEL = B.Kernel("ea_syrk", "kfk_ea_syrk",
                  [B.P, B.L, B.L, B.P, B.L, B.L, B.P, B.P,
                   B.I, B.I, B.I, B.F, B.F, B.I])


def ea_syrk_batched(M: torch.Tensor, X: torch.Tensor, keep: float,
                    coef: float) -> torch.Tensor:
    """M: (B, d, d), X: (B, d, n) fp32 CUDA → (B, d, d)."""
    batch, d, n = X.shape
    B.check_stack("ea_syrk", batch, M=M, X=X)
    B.check_shape("ea_syrk", "M", M, (batch, d, d))
    out = torch.empty((batch, d, d), device=X.device, dtype=torch.float32)
    splits = B.split_k(d, d, n, batch, sym=True)
    ws = B.workspace(splits, batch, d, d, X)
    KERNEL(*B.mat_args(M), *B.mat_args(X), B.ptr(out), B.ptr(ws),
           batch, d, n, float(keep), float(coef), splits)
    return out
