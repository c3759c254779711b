"""Brand's (2006) fast low-rank EVD modification — the paper's §2.3,
symmetric path.

Counterpart of ``src/repro/core/brand.py``: ``truncate``,
``sym_brand_update`` (Alg 3), ``ea_brand_step`` (Alg 4 lines 2-7) and
``init_from_factor``.  Eigenvalues are kept descending; a state (U, D)
represents U diag(D) Uᵀ.  Every function is stacked-native.

``use_kernel`` routes the two O(d)-sized ops of the update — the panel
(C, A⊥) and the tall-skinny QR of A⊥ — through ``kernels/ops.py``
(``brand_panel`` + ``cholqr2``); the O((r+n)²) eigenproblem stays in
``torch.linalg.eigh``.  The default keeps Householder ``torch.linalg.qr``.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from repro_torch.kernels.ref import eigh, mt as _mt

Tensor = torch.Tensor


def _desc_eigh(M: Tensor) -> Tuple[Tensor, Tensor]:
    """eigh with eigenvalues sorted descending. Returns (vals, vecs)."""
    vals, vecs = eigh(M)
    return vals.flip(-1), vecs.flip(-1)


def _batched_diag(D: Tensor) -> Tensor:
    """(..., r) → (..., r, r) diagonal matrices."""
    return torch.diag_embed(D)


def truncate(U: Tensor, D: Tensor, r: int) -> Tuple[Tensor, Tensor]:
    """Optimal rank-r truncation: keep the r strongest modes (a slice)."""
    return U[..., :, :r], D[..., :r]


def sym_brand_update(U: Tensor, D: Tensor, A: Tensor,
                     use_kernel: bool = False) -> Tuple[Tensor, Tensor]:
    """Symmetric Brand update (paper Alg 3):  X̂ = U diag(D) Uᵀ + A Aᵀ.

    U: (*stack, d, r) column-orthonormal, D: (*stack, r) descending,
    A: (*stack, d, n).  Returns (U', D') with U' (…, d, r+n), D' (…, r+n)
    descending.  With C = UᵀA and A⊥ = A − UC = Q R,
        X̂ = [U Q] [[diag(D)+CCᵀ, CRᵀ],[RCᵀ, RRᵀ]] [U Q]ᵀ.
    """
    if use_kernel:
        from repro_torch.kernels import ops as kops
        C, A_perp = kops.brand_panel(U, A)
        Q, R = kops.cholqr2(A_perp)
    else:
        C = _mt(U) @ A
        A_perp = A - U @ C
        Q, R = torch.linalg.qr(A_perp)
    top = torch.cat([_batched_diag(D) + C @ _mt(C), C @ _mt(R)], dim=-1)
    bot = torch.cat([R @ _mt(C), R @ _mt(R)], dim=-1)
    Ms = torch.cat([top, bot], dim=-2)               # (…, r+n, r+n)
    Dm, Wm = _desc_eigh(Ms)
    U_new = torch.cat([U, Q], dim=-1) @ Wm           # (…, d, r+n)
    return U_new, Dm


def ea_brand_step(U: Tensor, D: Tensor, X: Tensor, rho: float, r: int,
                  use_kernel: bool = False) -> Tuple[Tensor, Tensor]:
    """One B-KFAC K-factor step (paper Alg 4): truncate to r, then

        M ← ρ · trunc_r(U diag(D) Uᵀ) + (1-ρ) · X Xᵀ.

    X: (*stack, d, n).  Returns (U', D') of rank r+n."""
    Ut, Dt = truncate(U, D, r)
    return sym_brand_update(Ut, rho * Dt, math.sqrt(1.0 - rho) * X,
                            use_kernel=use_kernel)


def init_from_factor(X: Tensor, m: int) -> Tuple[Tensor, Tensor]:
    """Initialize a Brand state from the first factor M₀ = X Xᵀ without
    forming the d×d product (thin SVD of X).  Returns (U, D) padded with
    zero modes to width ``m``."""
    d, n = X.shape[-2:]
    Ux, s, _ = torch.linalg.svd(X, full_matrices=False)
    D = s * s
    if n >= m:
        return Ux[..., :, :m], D[..., :m]
    stack = X.shape[:-2]
    pad_u = X.new_zeros(stack + (d, m - n))
    pad_d = X.new_zeros(stack + (m - n,))
    return torch.cat([Ux, pad_u], dim=-1), torch.cat([D, pad_d], dim=-1)
