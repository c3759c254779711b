"""Inverse application of low-rank K-factor representations to gradients.

Counterpart of ``src/repro/core/precond.py``.

Paper Alg 1 (lines 14-18) — quadratic application:
    (U diag(D) Uᵀ + λI)⁻¹ applied exactly on the span and as (1/λ)I off it.
Paper Alg 8 — linear application from gradient factors (each low-rank
side through ``lowrank_apply`` with ``use_kernel``).
NS-mode (``dense_*``) sides hold the dense damped inverse in U and apply
by a plain GEMM.
Paper §3.5 spectrum continuation: shift the retained spectrum down by its
smallest retained eigenvalue and fold that amount into λ.

Every function is stacked-native with per-element λ.

**Row blocks** (tensor parallelism): where a gradient's sharded
dimension is the rows of one factor (the *panel side*, p), a rank holds
those rows of J and of that factor's U.  S = P̄⁻¹ J Ō⁻¹ is then made in
two passes with a sum between them: the panel Cg = diag(s_p) U_pᵀ J on
the local rows (:func:`rows_panel`), summed over the model axis by the
caller, then W = U_p Cg + J/λ_p and S = W Ō⁻¹ on the local rows with the
other side's U whole (:func:`rows_apply`).  With ``use_kernel`` these are
the ``precond_panel`` and ``precond_apply`` launches of
``ops.precond_fused``; without, the same split in plain matmuls.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import ref
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


def apply_inv_right(J: Tensor, U: Tensor, D: Tensor, lam: Tensor,
                    use_kernel: bool = False, out: Tensor = None) -> Tensor:
    """J @ (U diag(D) Uᵀ + λI)⁻¹ — right application (A-side).
    J: (..., p, d), U: (..., d, w).  With ``use_kernel`` it goes to
    ``ops.lowrank_apply`` (the CUDA kernel on the card)."""
    lam = _lam_safe(lam)
    if use_kernel:
        from repro_torch.kernels import ops as kops
        return kops.lowrank_apply(J, U, lowrank_inv_diag(D, lam), lam)
    T = (J @ U) * lowrank_inv_diag(D, lam)[..., None, :]
    # T Uᵀ + J/λ with one J-sized temporary (the sum in place: the same
    # bits as out of place), or none in ``out`` (storage of J's size that
    # is not J); a bucket of a full-width LM is gigabytes
    return torch.matmul(T, _mt(U), out=out).addcdiv_(J, _scal(lam, J))


def apply_inv_left(J: Tensor, U: Tensor, D: Tensor, lam: Tensor,
                   use_kernel: bool = False) -> Tensor:
    """(U diag(D) Uᵀ + λI)⁻¹ @ J — left application (Γ-side)."""
    return _mt(apply_inv_right(_mt(J), U, D, lam, use_kernel))


def kfac_precondition(J: Tensor, U_g: Tensor, D_g: Tensor, lam_g: Tensor,
                      U_a: Tensor, D_a: Tensor, lam_a: Tensor,
                      use_kernel: bool = False, dense_g: bool = False,
                      dense_a: bool = False, consume: bool = False
                      ) -> Tensor:
    """Full quadratic application (Alg 1): S = Γ̄⁻¹ J Ā⁻¹, J (…, d_out,
    d_in).  With ``use_kernel`` the two-sided application goes to
    ``ops.precond_fused`` (the CUDA kernel pair on the card).

    ``dense_g``/``dense_a`` mark NS-mode sides: U there is the dense
    damped inverse, applied by a plain GEMM (its D and λ are ignored);
    the other side, if low-rank, goes through ``apply_inv_*``.

    ``consume``: J is the caller's to overwrite; the plain two-sided
    application then makes its result in J's storage once J Ā⁻¹ is made
    (the same numbers, one J-sized temporary fewer)."""
    if dense_g or dense_a:
        M = J @ U_a if dense_a else apply_inv_right(J, U_a, D_a, lam_a,
                                                    use_kernel)
        return U_g @ M if dense_g else apply_inv_left(M, U_g, D_g, lam_g,
                                                      use_kernel)
    if use_kernel:
        from repro_torch.kernels import ops as kops
        lam_g, lam_a = _lam_safe(lam_g), _lam_safe(lam_a)
        return kops.precond_fused(J, U_g, lowrank_inv_diag(D_g, lam_g),
                                  lam_g, U_a, lowrank_inv_diag(D_a, lam_a),
                                  lam_a)
    M = apply_inv_right(J, U_a, D_a, lam_a)      # J Ā⁻¹
    if consume and J.is_contiguous():            # Γ̄⁻¹ (·) into J's storage
        out = J.view(_mt(M).shape)
        return _mt(apply_inv_right(_mt(M), U_g, D_g, lam_g, out=out))
    return apply_inv_left(M, U_g, D_g, lam_g)    # Γ̄⁻¹ (·)


def kfac_precondition_linear(G: Tensor, A: Tensor, U_g: Tensor, D_g: Tensor,
                             lam_g: Tensor, U_a: Tensor, D_a: Tensor,
                             lam_a: Tensor, use_kernel: bool = False,
                             dense_g: bool = False, dense_a: bool = False
                             ) -> Tensor:
    """Alg 8 — S = (Γ̄⁻¹ G)(Aᵀ Ā⁻¹) from gradient factors G (d_out, n),
    A (d_in, n): O(r·d·n) instead of O(r·d²), for n < d.  ``dense_*``
    as in ``kfac_precondition``."""
    Gp = (U_g @ G if dense_g
          else apply_inv_left(G, U_g, D_g, lam_g, use_kernel))
    Ap = (_mt(A) @ U_a if dense_a
          else apply_inv_right(_mt(A), U_a, D_a, lam_a, use_kernel))
    return Gp @ Ap


def _damped(D: Tensor, phi, continuation: bool) -> Tuple[Tensor, Tensor]:
    """Per-element λ from the spectrum, plus the §3.5 continuation shift."""
    lam = damping_from_spectrum(D, phi)
    if continuation:
        D, lam = spectrum_continuation(D, lam)
    return D, lam


def _damped_sides(D_g: Tensor, D_a: Tensor, phi, continuation: bool,
                  dense_g: bool, dense_a: bool):
    """(D_g, λ_g, D_a, λ_a): a dense (NS) side skips damping and the
    continuation (λ̂ is baked into its U) and gets λ = 1, unused."""
    one = torch.ones((), dtype=D_g.dtype, device=D_g.device)
    lam_g = lam_a = one
    if not dense_a:
        D_a, lam_a = _damped(D_a, phi, continuation)
    if not dense_g:
        D_g, lam_g = _damped(D_g, phi, continuation)
    return D_g, lam_g, D_a, lam_a


def precondition_with_damping(J: Tensor, U_g: Tensor, D_g: Tensor,
                              U_a: Tensor, D_a: Tensor, phi, *,
                              continuation: bool = True,
                              use_kernel: bool = False,
                              dense_g: bool = False,
                              dense_a: bool = False,
                              consume: bool = False) -> Tensor:
    """Damping + spectrum continuation + full quadratic application for a
    whole (possibly stacked) tap in one call — the optimizer's entry
    point.  J: (*stack, d_out, d_in); ``consume`` as in
    :func:`kfac_precondition`."""
    D_g, lam_g, D_a, lam_a = _damped_sides(D_g, D_a, phi, continuation,
                                           dense_g, dense_a)
    return kfac_precondition(J, U_g, D_g, lam_g, U_a, D_a, lam_a, use_kernel,
                             dense_g=dense_g, dense_a=dense_a,
                             consume=consume)


def precondition_linear_with_damping(G: Tensor, A: Tensor, U_g: Tensor,
                                     D_g: Tensor, U_a: Tensor, D_a: Tensor,
                                     phi, *, continuation: bool = True,
                                     use_kernel: bool = False,
                                     dense_g: bool = False,
                                     dense_a: bool = False) -> Tensor:
    """Damping + continuation + Alg-8 linear application."""
    D_g, lam_g, D_a, lam_a = _damped_sides(D_g, D_a, phi, continuation,
                                           dense_g, dense_a)
    return kfac_precondition_linear(G, A, U_g, D_g, lam_g, U_a, D_a, lam_a,
                                    use_kernel, dense_g=dense_g,
                                    dense_a=dense_a)


def rows_panel(J: Tensor, U_p: Tensor, s_p: Tensor,
               use_kernel: bool = False) -> Tensor:
    """The rank's part of the panel Cg = diag(s_p) U_pᵀ J from its rows
    of J (…, p_rows, d) and U_p (…, p_rows, w) → (…, w, d) fp32; the sum
    of the ranks' parts is the whole panel."""
    if use_kernel:
        from repro_torch.kernels import ops as kops
        return kops.precond_panel(U_p, J, s_p)
    return ref.precond_panel(U_p, J, s_p)


def rows_apply(J: Tensor, U_p: Tensor, Cg: Tensor, U_o: Tensor, D_o: Tensor,
               lam_p, lam_o, use_kernel: bool = False,
               dense_o: bool = False) -> Tensor:
    """The rank's rows of S = (U_p Cg + J/λ_p) Ō⁻¹ from its rows of J and
    U_p, the summed panel ``Cg`` and the other side whole: Ō⁻¹ =
    (U_o diag(D_o) U_oᵀ + λ_o I)⁻¹, or U_o itself where that side is
    dense (NS)."""
    lam_p = _lam_safe(lam_p)
    if use_kernel and not dense_o:
        from repro_torch.kernels import ops as kops
        lam_o = _lam_safe(lam_o)
        return kops.precond_apply(J, U_p, Cg, U_o,
                                  lowrank_inv_diag(D_o, lam_o), lam_p, lam_o)
    W = torch.matmul(U_p, Cg).addcdiv_(J, _scal(lam_p, J))
    if dense_o:
        return W @ U_o
    return apply_inv_right(W, U_o, D_o, lam_o)
