"""Brand's (2006) fast low-rank EVD modification — the paper's §2.3,
symmetric path.

Counterpart of ``src/repro/core/brand.py``: ``truncate``,
``sym_brand_update`` (Alg 3), ``ea_brand_step`` (Alg 4 lines 2-7) and
``init_from_factor``.  Eigenvalues are kept descending; a state (U, D)
represents U diag(D) Uᵀ.  Every function is stacked-native.

``use_kernel`` routes the two O(d)-sized ops of the update — the panel
(C, A⊥) and the tall-skinny QR of A⊥ — through ``kernels/ops.py``
(``ut_a``, ``a_perp``, then CholeskyQR2's ``syrk_tn`` and ``rinv_apply``
twice); the O((r+n)²) eigenproblem stays in ``torch.linalg.eigh``.  The
default keeps Householder ``torch.linalg.qr``.

**Row blocks.**  Under tensor parallelism a rank holds rows [r0, r0+rb)
of U and of A (``rows``, a ``distributed/sharding.py::RowBlock``).
Every reduction over the d rows is then the same reduction on the local
rows summed over the model axis: C = UᵀA is summed (so A⊥ = A − UC is
local), and the QR of A⊥ is CholeskyQR2 over rows with ``use_kernel``
(``ut_a``, ``a_perp``, ``syrk_tn`` and ``rinv_apply`` on the local rows,
the (n, n) Grams summed) or else a TSQR (a local Householder QR, the
stacked R factors gathered, one small QR): Householder QR up to column
signs, which U diag(D) Uᵀ does not see.  The (r+n)² eigenproblem runs
on every rank on the same summed inputs, so all take the same Wm.
Without ``rows`` every function is the one-device one.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.ref import eigh, mt as _mt, nonfinite_safe

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


def tsqr(A: Tensor, rows=None) -> Tuple[Tensor, Tensor]:
    """QR of a tall A (*stack, d, n) held by row blocks (A: the rank's
    (…, rb, n)): a local Householder QR, the ranks' R factors stacked
    (gathered over ``rows``' axis), one QR of the stack on every rank →
    (the rank's rows of Q, R), Q (…, rb, min(d, n)).  Without ``rows``
    the Householder QR of A."""
    Ql, Rl = torch.linalg.qr(A)
    if rows is None:
        return Ql, Rl
    k = Rl.shape[-2]
    Q2, R = torch.linalg.qr(rows.gather(Rl))
    return Ql @ Q2[..., rows.index * k:(rows.index + 1) * k, :], R


def cholqr2(A: Tensor, total) -> Tuple[Tensor, Tensor]:
    """``ref.cholqr2`` through the kernels' passes: ``syrk_tn`` and
    ``rinv_apply`` (``kernels/ops.py``: the kernels on the card), each
    (n, n) Gram through ``total`` (on row blocks its sum over the model
    axis), the clamped spectral roots on every rank → (Q, R), Q the
    rows of A's."""
    from repro_torch.kernels import ops as kops
    A32 = A.to(torch.float32)
    R1, B1 = ref.gram_inv_sqrt(total(kops.syrk_tn(A32)),
                               ref.CHOLQR_FLOOR_RESOLVE, "tr")
    Q0 = kops.rinv_apply(A32, B1)
    R2, B2 = ref.gram_inv_sqrt(total(kops.syrk_tn(Q0)),
                               ref.CHOLQR_FLOOR_REFINE, "max")
    return kops.rinv_apply(Q0, B2).to(A.dtype), R2 @ R1


def sym_brand_update(U: Tensor, D: Tensor, A: Tensor,
                     use_kernel: bool = False, rows=None
                     ) -> Tuple[Tensor, Tensor]:
    """Symmetric Brand update (paper Alg 3):  X̂ = U diag(D) Uᵀ + A Aᵀ.

    U: (*stack, d, r) column-orthonormal, D: (*stack, r) descending,
    A: (*stack, d, n).  Returns (U', D') with U' (…, d, r+n), D' (…, r+n)
    descending.  With C = UᵀA and A⊥ = A − UC = Q R,
        X̂ = [U Q] [[diag(D)+CCᵀ, CRᵀ],[RCᵀ, RRᵀ]] [U Q]ᵀ.
    With ``rows`` U and A (and U') are the rank's row blocks (the module
    docstring)."""
    total = (lambda x: x) if rows is None else rows.sum
    if use_kernel:
        from repro_torch.kernels import ops as kops
        C = total(kops.ut_a(U, A))
        Q, R = cholqr2(kops.a_perp(A, U, C), total)
    else:
        C = total(_mt(U) @ A)
        Q, R = tsqr(A - U @ C, rows)
    top = torch.cat([_batched_diag(D) + C @ _mt(C), C @ _mt(R)], dim=-1)
    bot = torch.cat([R @ _mt(C), R @ _mt(R)], dim=-1)
    Ms = torch.cat([top, bot], dim=-2)               # (…, r+n, r+n)
    Dm, Wm = _desc_eigh(Ms)
    U_new = torch.cat([U, Q], dim=-1) @ Wm           # (…, d, r+n)
    return U_new, Dm


def ea_brand_step(U: Tensor, D: Tensor, X: Tensor, rho: float, r: int,
                  use_kernel: bool = False, rows=None
                  ) -> Tuple[Tensor, Tensor]:
    """One B-KFAC K-factor step (paper Alg 4): truncate to r, then

        M ← ρ · trunc_r(U diag(D) Uᵀ) + (1-ρ) · X Xᵀ.

    X: (*stack, d, n) (with ``rows``: the rank's rows of U and X).
    Returns (U', D') of rank r+n."""
    Ut, Dt = truncate(U, D, r)
    return sym_brand_update(Ut, rho * Dt, math.sqrt(1.0 - rho) * X,
                            use_kernel=use_kernel, rows=rows)


def init_from_factor(X: Tensor, m: int, rows=None) -> Tuple[Tensor, Tensor]:
    """Initialize a Brand state from the first factor M₀ = X Xᵀ without
    forming the d×d product (thin SVD of X; NaN for a nonfinite X, as
    the reference).  Returns (U, D) padded with zero modes to width
    ``m``.  With ``rows`` (X the rank's row block) the SVD is a TSQR
    followed by the SVD of its small R, and U is the rank's rows."""
    d, n = X.shape[-2:]
    svd = lambda A: torch.linalg.svd(A, full_matrices=False)
    if rows is not None:
        Q, R = tsqr(X, rows)
        Ur, s, _ = nonfinite_safe(svd, R, lambda: torch.zeros_like(R))
        Ux = Q @ Ur
    else:
        Ux, s, _ = nonfinite_safe(svd, X, lambda: torch.zeros_like(X))
    D = s * s
    if n >= m:
        return Ux[..., :, :m], D[..., :m]
    stack = X.shape[:-2]
    pad_u = X.new_zeros(stack + (d, m - n))
    pad_d = X.new_zeros(stack + (m - n,))
    return torch.cat([Ux, pad_u], dim=-1), torch.cat([D, pad_d], dim=-1)
