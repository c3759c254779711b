"""CholeskyQR2 on the card: the two O(d·n²) passes as CUDA kernels, the
small (n, n) clamped spectral root (``ref.eigh``) between them.

Counterpart of ``src/repro/kernels/cholqr.py`` (Pallas,
``syrk_tn_batched_pallas`` + ``rinv_apply_batched_pallas``, orchestrated
by ``cholqr2_batched_pallas``); the kernels are in ``csrc/cholqr.cu`` and
the plain versions are ``ref.syrk_tn``, ``ref.rinv_apply`` and
``ref.cholqr2``.  CUDA tensors only.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import _build as B
from repro_torch.kernels import ref

SYRK_TN = B.Kernel("syrk_tn", "kfk_syrk_tn",
                   [B.P, B.L, B.L, B.P, B.P, B.P, B.I, B.I, B.I, B.I, B.I])
RINV_APPLY = B.Kernel("rinv_apply", "kfk_rinv_apply",
                      [B.P, B.L, B.L, B.P, B.L, B.L, B.P, B.P, B.P,
                       B.I, B.I, B.I, B.I, B.I])


def syrk_tn_batched(A: torch.Tensor) -> torch.Tensor:
    """G = AᵀA in fp32.  A: (B, d, n) → (B, n, n).  One launch on the
    3xTF32 tensor-core mainloop, bitwise the same from run to run."""
    batch, d, n = A.shape
    B.check_stack("syrk_tn", batch, A=A)
    G = torch.empty((batch, n, n), device=A.device, dtype=torch.float32)
    ws, counters, splits, cluster = B.tc_launch_args(n, n, d, batch, A,
                                                     sym=True)
    SYRK_TN(*B.mat_args(A), B.ptr(G), ws, counters, batch, d, n, splits,
            cluster)
    return G


def rinv_apply_batched(A: torch.Tensor, Rinv: torch.Tensor) -> torch.Tensor:
    """Q = A Rinv.  A: (B, d, n), Rinv: (B, n, n) → (B, d, n)."""
    batch, d, n = A.shape
    B.check_stack("rinv_apply", batch, A=A, Rinv=Rinv)
    B.check_shape("rinv_apply", "Rinv", Rinv, (batch, n, n))
    Q = torch.empty((batch, d, n), device=A.device, dtype=torch.float32)
    ws, counters, splits, cluster = B.pipe_launch_args(d, n, n, batch, A)
    RINV_APPLY(*B.mat_args(A), *B.mat_args(Rinv), B.ptr(Q), ws, counters,
               batch, d, n, splits, cluster)
    return Q


def cholqr2_batched(A: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(Q, R) by the same two-round schedule as ``ref.cholqr2``: Gram SYRK
    → clamped spectral inverse root → apply, twice.  A: (B, d, n) fp32."""
    G1 = syrk_tn_batched(A)
    R1, B1 = ref.gram_inv_sqrt(G1, ref.CHOLQR_FLOOR_RESOLVE, "tr")
    Q0 = rinv_apply_batched(A, B1)
    G2 = syrk_tn_batched(Q0)
    R2, B2 = ref.gram_inv_sqrt(G2, ref.CHOLQR_FLOOR_REFINE, "max")
    Q = rinv_apply_batched(Q0, B2)
    return Q, R2 @ R1
