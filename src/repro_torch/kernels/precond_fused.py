"""Two-sided K-FAC preconditioning on the card:
S = (U_g diag(s_g) U_gᵀ + I/λ_g) J (U_a diag(s_a) U_aᵀ + I/λ_a).

Counterpart of ``src/repro/kernels/precond_fused.py`` (Pallas,
``precond_fused_pallas``: a panel pass and a J-resident apply pass); the
kernels are in ``csrc/precond_fused.cu`` and the plain versions are
``ref.precond_panel``, ``ref.precond_apply`` and ``ref.precond_fused``.
The apply pass writes W = Γ̄⁻¹J and Tw = W U_a diag(s_a) to workspaces
allocated here (see the note in the ``.cu``).  CUDA tensors only.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build as B

PANEL = B.Kernel("precond_panel", "kfk_precond_panel",
                 [B.P, B.L, B.L, B.P, B.L, B.L, B.P, B.L, B.P, B.P,
                  B.I, B.I, B.I, B.I, B.I])
APPLY = B.Kernel("precond_apply", "kfk_precond_apply",
                 [B.P, B.L, B.L, B.P, B.L, B.L, B.P, B.L, B.L,
                  B.P, B.L, B.L, B.P, B.L, B.P, B.P, B.P, B.P, B.P,
                  B.I, B.I, B.I, B.I, B.I])


def precond_panel_batched(U_g: torch.Tensor, J: torch.Tensor,
                          s_g: torch.Tensor) -> torch.Tensor:
    """Cg = diag(s_g) U_gᵀ J.  U_g: (B, p, w_g), J: (B, p, d), s_g: (B, w_g)
    → (B, w_g, d)."""
    batch, p, d = J.shape
    w_g = U_g.shape[-1]
    B.check_stack("precond_panel", batch, U_g=U_g, J=J)
    B.check_shape("precond_panel", "U_g", U_g, (batch, p, w_g))
    B.check_vec("precond_panel", batch, w_g, s_g=s_g)
    Cg = torch.empty((batch, w_g, d), device=J.device, dtype=torch.float32)
    splits = B.split_k(w_g, d, p, batch)
    ws = B.workspace(splits, batch, w_g, d, J)
    PANEL(*B.mat_args(U_g), *B.mat_args(J), B.ptr(s_g), B.L(s_g.stride(0)),
          B.ptr(Cg), B.ptr(ws), batch, p, d, w_g, splits)
    return Cg


def precond_apply_batched(J: torch.Tensor, U_g: torch.Tensor,
                          Cg: torch.Tensor, U_a: torch.Tensor,
                          s_a: torch.Tensor, ilam_g: torch.Tensor,
                          ilam_a: torch.Tensor) -> torch.Tensor:
    """S = (W U_a) diag(s_a) U_aᵀ + W/λ_a with W = U_g Cg + J/λ_g.
    J: (B, p, d), U_g: (B, p, w_g), Cg: (B, w_g, d), U_a: (B, d, w_a),
    s_a: (B, w_a), ilam_g/ilam_a: (B,) → (B, p, d)."""
    batch, p, d = J.shape
    w_g = U_g.shape[-1]
    w_a = U_a.shape[-1]
    B.check_stack("precond_apply", batch, J=J, U_g=U_g, Cg=Cg, U_a=U_a)
    B.check_shape("precond_apply", "U_g", U_g, (batch, p, w_g))
    B.check_shape("precond_apply", "Cg", Cg, (batch, w_g, d))
    B.check_shape("precond_apply", "U_a", U_a, (batch, d, w_a))
    B.check_vec("precond_apply", batch, w_a, s_a=s_a)
    B.check_vec("precond_apply", 1, batch, ilam_g=ilam_g.reshape(1, -1),
                ilam_a=ilam_a.reshape(1, -1))
    dev = J.device
    W = torch.empty((batch, p, d), device=dev, dtype=torch.float32)
    Tw = torch.empty((batch, p, w_a), device=dev, dtype=torch.float32)
    S = torch.empty((batch, p, d), device=dev, dtype=torch.float32)
    APPLY(*B.mat_args(J), *B.mat_args(U_g), *B.mat_args(Cg),
          *B.mat_args(U_a), B.ptr(s_a), B.L(s_a.stride(0)),
          B.ptr(ilam_g), B.ptr(ilam_a), B.ptr(W), B.ptr(Tw), B.ptr(S),
          batch, p, d, w_g, w_a)
    return S


def precond_fused_batched(J, U_g, s_g, ilam_g, U_a, s_a, ilam_a
                          ) -> torch.Tensor:
    """The whole two-sided application for a stack: panel, then apply."""
    Cg = precond_panel_batched(U_g, J, s_g)
    return precond_apply_batched(J, U_g, Cg, U_a, s_a, ilam_g, ilam_a)
