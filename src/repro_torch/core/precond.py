"""Inverse application of low-rank K-factor representations to gradients.

Counterpart of ``src/repro/core/precond.py``.

Paper Alg 1 (lines 14-18) — quadratic application:
    (U diag(D) Uᵀ + λI)⁻¹ applied exactly on the span and as (1/λ)I off it.
Paper Alg 8 — linear application from gradient factors (plain torch only
here; its kernel route, ``lowrank_apply``, belongs to a later slice).
Paper §3.5 spectrum continuation: shift the retained spectrum down by its
smallest retained eigenvalue and fold that amount into λ.

Every function is stacked-native with per-element λ.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.ref import mt as _mt, scal as _scal

Tensor = torch.Tensor


def spectrum_continuation(D: Tensor, lam: Tensor) -> Tuple[Tensor, Tensor]:
    """λ ← λ + min D, D ← D − (min D)  (paper §3.5), min over the retained
    (positive) modes.  D: (..., w), lam: (...,)."""
    pos = D > 0
    inf = torch.full_like(D, float("inf"))
    dmin = torch.amin(torch.where(pos, D, inf), dim=-1)
    dmin = torch.where(torch.isfinite(dmin), dmin, torch.zeros_like(dmin))
    return torch.clamp(D - dmin[..., None], min=0.0), lam + dmin


def damping_from_spectrum(D: Tensor, phi) -> Tensor:
    """Paper §6: λ = φ_λ · λ_max.  D: (..., w) → λ: (...,)."""
    return phi * torch.clamp(torch.amax(D, dim=-1), min=1e-12)


#: floor for λ in the inverse-diagonal split (see the reference: an
#: undamped config or a fully-clamped spectrum must not emit inf/NaN)
_LAM_EPS = 1e-12


def lowrank_inv_diag(D: Tensor, lam: Tensor) -> Tensor:
    """The diagonal (D+λ)⁻¹ − 1/λ used on the span; λ and D+λ floored at
    ``_LAM_EPS``."""
    lam = _lam_safe(lam)[..., None]
    return 1.0 / torch.clamp(D + lam, min=_LAM_EPS) - 1.0 / lam


def _lam_safe(lam) -> Tensor:
    """The same λ floor for the off-span J/λ term."""
    return torch.clamp(torch.as_tensor(lam), min=_LAM_EPS)


def apply_inv_right(J: Tensor, U: Tensor, D: Tensor, lam: Tensor) -> Tensor:
    """J @ (U diag(D) Uᵀ + λI)⁻¹ — right application (A-side).
    J: (..., p, d), U: (..., d, w)."""
    lam = _lam_safe(lam)
    T = (J @ U) * lowrank_inv_diag(D, lam)[..., None, :]
    return T @ _mt(U) + J / _scal(lam, J)


def apply_inv_left(J: Tensor, U: Tensor, D: Tensor, lam: Tensor) -> Tensor:
    """(U diag(D) Uᵀ + λI)⁻¹ @ J — left application (Γ-side)."""
    return _mt(apply_inv_right(_mt(J), U, D, lam))


def kfac_precondition(J: Tensor, U_g: Tensor, D_g: Tensor, lam_g: Tensor,
                      U_a: Tensor, D_a: Tensor, lam_a: Tensor,
                      use_kernel: bool = False) -> Tensor:
    """Full quadratic application (Alg 1): S = Γ̄⁻¹ J Ā⁻¹, J (…, d_out,
    d_in).  With ``use_kernel`` the two-sided application goes to
    ``ops.precond_fused`` (the CUDA kernel pair on the card)."""
    if use_kernel:
        from repro_torch.kernels import ops as kops
        lam_g, lam_a = _lam_safe(lam_g), _lam_safe(lam_a)
        return kops.precond_fused(J, U_g, lowrank_inv_diag(D_g, lam_g),
                                  lam_g, U_a, lowrank_inv_diag(D_a, lam_a),
                                  lam_a)
    M = apply_inv_right(J, U_a, D_a, lam_a)      # J Ā⁻¹
    return apply_inv_left(M, U_g, D_g, lam_g)    # Γ̄⁻¹ (·)


def kfac_precondition_linear(G: Tensor, A: Tensor, U_g: Tensor, D_g: Tensor,
                             lam_g: Tensor, U_a: Tensor, D_a: Tensor,
                             lam_a: Tensor) -> Tensor:
    """Alg 8 — S = (Γ̄⁻¹ G)(Aᵀ Ā⁻¹) from gradient factors G (d_out, n),
    A (d_in, n).  Plain torch: the ``lowrank_apply`` kernel route is a
    later slice."""
    return apply_inv_left(G, U_g, D_g, lam_g) @ apply_inv_right(
        _mt(A), U_a, D_a, lam_a)


def _damped(D: Tensor, phi, continuation: bool) -> Tuple[Tensor, Tensor]:
    """Per-element λ from the spectrum, plus the §3.5 continuation shift."""
    lam = damping_from_spectrum(D, phi)
    if continuation:
        D, lam = spectrum_continuation(D, lam)
    return D, lam


def precondition_with_damping(J: Tensor, U_g: Tensor, D_g: Tensor,
                              U_a: Tensor, D_a: Tensor, phi, *,
                              continuation: bool = True,
                              use_kernel: bool = False) -> Tensor:
    """Damping + spectrum continuation + full quadratic application for a
    whole (possibly stacked) tap in one call — the optimizer's entry
    point.  J: (*stack, d_out, d_in)."""
    D_a, lam_a = _damped(D_a, phi, continuation)
    D_g, lam_g = _damped(D_g, phi, continuation)
    return kfac_precondition(J, U_g, D_g, lam_g, U_a, D_a, lam_a, use_kernel)


def precondition_linear_with_damping(G: Tensor, A: Tensor, U_g: Tensor,
                                     D_g: Tensor, U_a: Tensor, D_a: Tensor,
                                     phi, *, continuation: bool = True
                                     ) -> Tensor:
    """Damping + continuation + Alg-8 linear application."""
    D_a, lam_a = _damped(D_a, phi, continuation)
    D_g, lam_g = _damped(D_g, phi, continuation)
    return kfac_precondition_linear(G, A, U_g, D_g, lam_g, U_a, D_a, lam_a)
