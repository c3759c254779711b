"""The Brand update's O(d·r·n) panel on the card:  C = UᵀA,  A⊥ = A − U C.

Counterpart of ``src/repro/kernels/brand_panel.py`` (Pallas,
``ut_a_batched_pallas`` + ``a_perp_batched_pallas``); the kernels are in
``csrc/brand_panel.cu`` and their plain versions are ``ref.ut_a``,
``ref.a_perp`` and ``ref.brand_panel``.  CUDA tensors only.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import _build as B

UT_A = B.Kernel("ut_a", "kfk_ut_a",
                [B.P, B.L, B.L, B.P, B.L, B.L, B.P, B.P, B.P,
                 B.I, B.I, B.I, B.I, B.I, B.I])
A_PERP = B.Kernel("a_perp", "kfk_a_perp",
                  [B.P, B.L, B.L, B.P, B.L, B.L, B.P, B.L, B.L, B.P, B.P,
                   B.P, B.I, B.I, B.I, B.I, B.I, B.I])


def ut_a_batched(U: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
    """C = UᵀA.  U: (B, d, r), A: (B, d, n) → (B, r, n).  One launch,
    bitwise the same from run to run."""
    batch, d, r = U.shape
    n = A.shape[-1]
    B.check_stack("ut_a", batch, U=U, A=A)
    B.check_shape("ut_a", "A", A, (batch, d, n))
    C = torch.empty((batch, r, n), device=A.device, dtype=torch.float32)
    ws, counters, splits, cluster = B.pipe_launch_args(r, n, d, batch, A)
    UT_A(*B.mat_args(U), *B.mat_args(A), B.ptr(C), ws, counters,
         batch, d, r, n, splits, cluster)
    return C


def a_perp_batched(A: torch.Tensor, U: torch.Tensor, C: torch.Tensor
                   ) -> torch.Tensor:
    """A⊥ = A − U C.  A: (B, d, n), U: (B, d, r), C: (B, r, n).  One
    launch on the 3xTF32 tensor-core mainloop, bitwise the same from run
    to run."""
    batch, d, n = A.shape
    r = U.shape[-1]
    B.check_stack("a_perp", batch, A=A, U=U, C=C)
    B.check_shape("a_perp", "U", U, (batch, d, r))
    B.check_shape("a_perp", "C", C, (batch, r, n))
    P = torch.empty((batch, d, n), device=A.device, dtype=torch.float32)
    ws, counters, splits, cluster = B.tc_launch_args(d, n, r, batch, A)
    A_PERP(*B.mat_args(A), *B.mat_args(U), *B.mat_args(C), B.ptr(P), ws,
           counters, batch, d, r, n, splits, cluster)
    return P


def brand_panel_batched(U: torch.Tensor, A: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(C, A⊥) for a whole stack: two launches."""
    C = ut_a_batched(U, A)
    return C, a_perp_batched(A, U, C)
