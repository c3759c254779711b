"""Batched GEMM with a scale-and-add epilogue on the card:
out = α·C + β·A B — the Newton–Schulz refinement's building block.

Counterpart of ``src/repro/kernels/ns_inverse.py`` (Pallas,
``gemm_update_batched_pallas``); the kernel is ``csrc/ns_inverse.cu``, on
the 3xTF32 tensor-core mainloop of ``csrc/tc_gemm.cuh``, and its plain
version ``ref.gemm_update`` (``ref.ns_step`` for a whole step).
With α = 0 the addend C is not read and may be ``None``.  CUDA tensors
only — ``ops.ns_step`` dispatches and sends CPU tensors to the plain
version.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build as B

KERNEL = B.Kernel("ns_gemm_update", "kfk_ns_gemm_update",
                  [B.P, B.L, B.L, B.P, B.L, B.L, B.P, B.L, B.L, B.P,
                   B.I, B.I, B.I, B.I, B.F, B.F, B.I])


def gemm_update_batched(C: Optional[torch.Tensor], A: torch.Tensor,
                        Bm: torch.Tensor, alpha: float, beta: float
                        ) -> torch.Tensor:
    """A: (B, m, k), Bm: (B, k, n), C: (B, m, n) or None when α = 0
    → (B, m, n).  α and β are shared by the stack."""
    batch, m, k = A.shape
    n = Bm.shape[-1]
    B.check_stack("ns_gemm_update", batch, A=A, B=Bm)
    B.check_shape("ns_gemm_update", "B", Bm, (batch, k, n))
    if alpha != 0.0:
        if C is None:
            raise ValueError("ns_gemm_update: C is required when alpha != 0")
        B.check_stack("ns_gemm_update", batch, C=C)
        B.check_shape("ns_gemm_update", "C", C, (batch, m, n))
        c_args = B.mat_args(C)
    else:
        c_args = [B.P(0), B.L(0), B.L(0)]
    out = torch.empty((batch, m, n), device=A.device, dtype=torch.float32)
    splits = B.tc_launch_split(m, n, k, batch, A)
    KERNEL(*c_args, *B.mat_args(A), *B.mat_args(Bm), B.ptr(out),
           batch, m, n, k, float(alpha), float(beta), splits)
    return out


def ns_step_batched(Mhat: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """One Newton–Schulz step X ← 2X − X(M̂X): two launches.
    Mhat, X: (B, d, d)."""
    T = gemm_update_batched(None, Mhat, X, 0.0, 1.0)
    return gemm_update_batched(X, X, T, 2.0, -1.0)
