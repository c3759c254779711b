"""Plain PyTorch versions of every kernel on the port's path.

Counterpart of ``src/repro/kernels/ref.py``.  These define the semantics:
the CPU runs them (``ops.py`` sends every CPU tensor here), and
``chip_smoke.py`` holds each CUDA kernel against them on the card.

Every function is stacked-native: operands may carry leading stack axes
and broadcast like ``torch.matmul``.  Per-element scalars (λ) may be
Python scalars, 0-d tensors or tensors of the stack shape.
"""
from __future__ import annotations

from typing import Tuple

import torch

Tensor = torch.Tensor


def mt(x: Tensor) -> Tensor:
    """Matrix transpose on the trailing two axes."""
    return x.transpose(-1, -2)


def scal(v, like: Tensor) -> Tensor:
    """Broadcast a per-element scalar (any stack shape) against the trailing
    two matrix axes of ``like``."""
    v = torch.as_tensor(v, dtype=like.dtype, device=like.device)
    return v[..., None, None]


def nonfinite_safe(fn, A: Tensor, fill):
    """``fn(A)`` for a batched factorization that raises on a matrix with
    a nonfinite entry (LAPACK / cuSOLVER convergence errors): the batch
    elements with one give NaN outputs instead, as the reference's
    factorizations do, so a poisoned step reaches the health guard
    (``train/health.py``) which drops it; the finite elements are
    factorized as usual (``fill()``, a finite matrix, stands in for the
    others).  The check runs only after ``fn`` has raised."""
    try:
        return fn(A)
    except torch.linalg.LinAlgError:
        ok = torch.isfinite(A).all(-1).all(-1)
        if bool(ok.all()):
            raise
        outs = fn(torch.where(ok[..., None, None], A, fill()))
        return tuple(o.masked_fill(~ok.reshape(ok.shape + (1,) * (
            o.dim() - ok.dim())), float("nan")) for o in outs)


def eigh(M: Tensor) -> Tuple[Tensor, Tensor]:
    """Symmetric eigendecomposition (ascending), computed in float64 and
    returned in M's dtype.  Every eigh of the path is small — (n, n)
    Grams, the (r+n)² Brand middle matrix, (k, k) RSVD projections, dense
    factors up to d = 256.  Measured by ``python -m
    repro_torch.tools.eigh_precision`` on both devices:

    - CPU: fp32 LAPACK ``ssyevd`` fails to converge, or returns non-finite
      values, on some finite rank-deficient Brand middle matrices (160×160
      at the small preset, batch 8, whose padded stats rows are zero);
      the float64 routine does not.
    - H100: cuSOLVER's fp32 eigh converges on every matrix of the path,
      but for n ≥ 106 it takes 1.4–3.4× the time of this float64 route,
      and its eigenvalues stray by up to 4.6e-4 of max |M|.

    A matrix with a nonfinite entry gives NaN results (``nonfinite_safe``).
    """
    M64 = M.to(torch.float64)
    vals, vecs = nonfinite_safe(torch.linalg.eigh, M64, lambda: torch.eye(
        M.shape[-1], dtype=M64.dtype, device=M.device))
    return vals.to(M.dtype), vecs.to(M.dtype)


def ea_syrk(M: Tensor, X: Tensor, rho, first) -> Tensor:
    """EA K-factor update:  M ← keep·M + coef·X Xᵀ with
    keep = ρ·(1-first), coef = 1-ρ·(1-first)   (paper eq. 5, κ(0)=1)."""
    rho = torch.as_tensor(rho, dtype=M.dtype, device=M.device)
    firstf = torch.as_tensor(float(first), dtype=M.dtype, device=M.device)
    keep = rho * (1.0 - firstf)
    coef = 1.0 - keep
    return keep * M + coef * (X @ mt(X)).to(M.dtype)


def ut_a(U: Tensor, A: Tensor) -> Tensor:
    """C = UᵀA (the first half of the Brand panel)."""
    return mt(U) @ A


def a_perp(A: Tensor, U: Tensor, C: Tensor) -> Tensor:
    """A⊥ = A − U C (the second half of the Brand panel)."""
    return A - U @ C


def brand_panel(U: Tensor, A: Tensor) -> Tuple[Tensor, Tensor]:
    """The O(d·r·n) panel of Brand's update:  C = UᵀA,  A⊥ = A − U C."""
    C = ut_a(U, A)
    return C, a_perp(A, U, C)


def lowrank_apply(X: Tensor, U: Tensor, s: Tensor, lam) -> Tensor:
    """Y = (X U) diag(s) Uᵀ + X/λ  (paper Alg 1 lines 15-17, factored).

    X: (..., p, d), U: (..., d, w), s: (..., w), lam: scalar or (...,).
    """
    T = (X @ U) * s[..., None, :]
    return T @ mt(U) + X / scal(lam, X)


def gemm_update(C: Tensor, A: Tensor, B: Tensor, alpha, beta) -> Tensor:
    """out = α·C + β·A B — one launch of the ``ns_inverse`` kernel.
    With α = 0, C is not read (as in the kernel)."""
    AB = beta * (A @ B)
    return AB if alpha == 0 else alpha * C + AB


def ns_step(Mhat: Tensor, X: Tensor) -> Tensor:
    """One Newton–Schulz/Hotelling inverse-refinement step
    X ← X(2I − M̂X) = 2X − X(M̂X) — two GEMMs, no factorization.
    Mhat, X: (..., d, d)."""
    T = Mhat @ X
    return 2.0 * X - X @ T


def syrk_tn(A: Tensor) -> Tensor:
    """Gram matrix G = AᵀA in float32 (the CholeskyQR SYRK pass)."""
    A32 = A.to(torch.float32)
    return mt(A32) @ A32


def rinv_apply(A: Tensor, Rinv: Tensor) -> Tensor:
    """Q = A @ R⁻¹ (the CholeskyQR row-parallel apply, with the tiny (n, n)
    inverse root precomputed)."""
    return (A.to(torch.float32) @ Rinv).to(A.dtype)


#: pass-1 spectral floor, ×tr(G): Gram eigenvalues below ~64·eps_fp32 of
#: the trace are unresolvable in an fp32 AᵀA — treated as exact zeros.
CHOLQR_FLOOR_RESOLVE = 64 * 1.19e-7
#: pass-2 spectral floor, ×λ_max(G): after pass 1 every retained direction
#: has Gram eigenvalue ≈ 1 and every suppressed one ≈ 0.
CHOLQR_FLOOR_REFINE = 0.25


def gram_inv_sqrt(G: Tensor, floor_rel: float, floor_mode: str
                  ) -> Tuple[Tensor, Tensor]:
    """Clamped spectral root of a Gram matrix: (R, B) with R = V√Λ̂Vᵀ and
    B = VΛ̂^{-1/2}Vᵀ, where Λ̂ zeroes every eigenvalue below
    floor_rel · tr(G) (``floor_mode="tr"``) or floor_rel · λ_max
    (``"max"``).  See the reference for why a clamp replaces Cholesky."""
    vals, vecs = eigh(G)                              # ascending
    if floor_mode == "tr":
        scale = torch.diagonal(G, dim1=-2, dim2=-1).sum(-1)
    elif floor_mode == "max":
        scale = vals[..., -1]
    else:
        raise ValueError(floor_mode)
    keep = vals > floor_rel * scale[..., None] + 1e-30
    safe = torch.where(keep, vals, torch.ones_like(vals))
    inv = torch.where(keep, 1.0 / torch.sqrt(safe), torch.zeros_like(vals))
    sq = torch.where(keep, torch.sqrt(safe), torch.zeros_like(vals))
    R = (vecs * sq[..., None, :]) @ mt(vecs)
    B = (vecs * inv[..., None, :]) @ mt(vecs)
    return R, B


def cholqr2(A: Tensor) -> Tuple[Tensor, Tensor]:
    """Tall-skinny QR by the CholeskyQR2 iteration with a clamped spectral
    root as the small factorization:  A ≈ Q R, Q (…, d, n) spanning an
    orthonormal-or-null subspace, R (…, n, n) symmetric psd, float32."""
    A32 = A.to(torch.float32)
    R1, B1 = gram_inv_sqrt(syrk_tn(A32), CHOLQR_FLOOR_RESOLVE, "tr")
    Q0 = rinv_apply(A32, B1)
    R2, B2 = gram_inv_sqrt(syrk_tn(Q0), CHOLQR_FLOOR_REFINE, "max")
    Q = rinv_apply(Q0, B2).to(A.dtype)
    return Q, R2 @ R1


def precond_panel(U_g: Tensor, J: Tensor, s_g: Tensor) -> Tensor:
    """Cg = diag(s_g) (U_gᵀ J) — the panel pass of ``precond_fused``."""
    return (mt(U_g) @ J) * s_g[..., :, None]


def precond_apply(J: Tensor, U_g: Tensor, Cg: Tensor, U_a: Tensor,
                  s_a: Tensor, lam_g, lam_a) -> Tensor:
    """S = lowrank_apply(W, U_a, s_a, λ_a) with W = U_g Cg + J/λ_g — the
    apply pass of ``precond_fused``."""
    W = U_g @ Cg + J / scal(lam_g, J)
    return lowrank_apply(W, U_a, s_a, lam_a)


def precond_fused(J: Tensor, U_g: Tensor, s_g: Tensor, lam_g,
                  U_a: Tensor, s_a: Tensor, lam_a) -> Tensor:
    """Fused two-sided application  S = Γ̄⁻¹ J Ā⁻¹  (paper Alg 1):

        S = (U_g diag(s_g) U_gᵀ + I/λ_g) J (U_a diag(s_a) U_aᵀ + I/λ_a)

    J: (..., p, d), U_g: (..., p, w_g), U_a: (..., d, w_a).
    """
    return precond_apply(J, U_g, precond_panel(U_g, J, s_g), U_a, s_a,
                         lam_g, lam_a)
