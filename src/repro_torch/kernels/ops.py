"""Public kernel entry points with dispatch by device.

Counterpart of ``src/repro/kernels/ops.py``.  The rule is one line: a CUDA
tensor always launches the hand-written kernel, a CPU tensor always takes
the plain version in ``ref.py``.  There is no environment switch and no
fallback: a CUDA kernel masks its own ragged edges, so it takes every shape
(d = 10 and 27 included) without the TPU's 128-lane padding, and the CUDA
``precond_fused`` covers every shape itself (no unfused route).

Output dtypes are the reference's (Pallas ``out_shape``): every kernel
computes in fp32, and the op casts its output back to the input's dtype
(``cholqr2``'s R stays fp32, as in the reference).

Stacked inputs: every op accepts leading stack axes.  They are broadcast
to one shape (``_common_stack``) and flattened into one batch axis
(``_flat``), so a whole stack runs as one batched launch.  A matrix shared
across the stack keeps batch stride 0 (no copy); the kernels read each
operand through its row and batch strides, and only need rows contiguous
(``lowrank_apply``'s X: rows or columns).
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from repro_torch.kernels import ref
from repro_torch.kernels import brand_panel as _bp
from repro_torch.kernels import cholqr as _cq
from repro_torch.kernels import ea_syrk as _ea
from repro_torch.kernels import lowrank_apply as _la
from repro_torch.kernels import ns_inverse as _ns
from repro_torch.kernels import precond_fused as _pf

Tensor = torch.Tensor


def _common_stack(*xs_cores: Tuple[Tensor, int]) -> Tuple[int, ...]:
    """Broadcast the leading (stack) axes of all operands to one shape."""
    return tuple(torch.broadcast_shapes(
        *(x.shape[:x.dim() - core] for x, core in xs_cores)))


def _flat(x: Tensor, core: int, stack: Tuple[int, ...],
          columns: bool = False) -> Tensor:
    """(*stack-broadcastable, *core_shape) → (B, *core_shape), fp32, with
    contiguous rows (batch and row strides are left as they are) — or,
    with ``columns``, contiguous columns left as they are too."""
    tail = tuple(x.shape[x.dim() - core:])
    b = math.prod(stack) if stack else 1
    x = x.to(torch.float32).expand(stack + tail).reshape((b,) + tail)
    if x.shape[-1] > 1 and x.stride(-1) != 1 and not (
            columns and _la.columns(x)):
        x = x.contiguous()
    return x


def _stack_lam(lam, stack: Tuple[int, ...], b: int, like: Tensor) -> Tensor:
    """Per-element scalar → contiguous (B,) float32."""
    lam = torch.as_tensor(lam, dtype=torch.float32, device=like.device)
    lam = lam.expand(stack) if stack else lam.reshape(())
    return lam.reshape((b,)).contiguous()


def ea_syrk(M: Tensor, X: Tensor, rho, first, X_rows=None) -> Tensor:
    """M ← keep·M + coef·X Xᵀ (EA update, paper eq. 5).
    M: (*stack, d, d), X: (*stack, d, n); ``rho`` float, ``first`` bool.
    With ``X_rows`` (*stack, rb, n), rows of X (a view of them), M is the
    same rows of the factor, (*stack, rb, d): keep·M + coef·X_rows Xᵀ."""
    if not X.is_cuda:
        return ref.ea_syrk(M, X, rho, first, X_rows)
    d = X.shape[-2]
    rows = d if X_rows is None else X_rows.shape[-2]
    stack = _common_stack((M, 2), (X, 2))
    keep = np.float32(rho) * (np.float32(1.0) - np.float32(bool(first)))
    coef = np.float32(1.0) - keep
    out = _ea.ea_syrk_batched(
        _flat(M, 2, stack), _flat(X, 2, stack), float(keep), float(coef),
        None if X_rows is None else _flat(X_rows, 2, stack))
    return out.to(M.dtype).reshape(stack + (rows, d))


def ns_step(Mhat: Tensor, X: Tensor) -> Tensor:
    """One Newton–Schulz step X ← 2X − X(M̂X) — two launches of the
    ``ns_inverse`` kernel.  Mhat, X: (*stack, d, d)."""
    if not X.is_cuda:
        return ref.ns_step(Mhat, X)
    d = X.shape[-1]
    stack = _common_stack((Mhat, 2), (X, 2))
    out = _ns.ns_step_batched(_flat(Mhat, 2, stack), _flat(X, 2, stack))
    return out.to(X.dtype).reshape(stack + (d, d))


def brand_panel(U: Tensor, A: Tensor) -> Tuple[Tensor, Tensor]:
    """(C, A⊥) = (UᵀA, A − U(UᵀA)).
    U: (*stack, d, r), A: (*stack, d, n)."""
    if not A.is_cuda:
        return ref.brand_panel(U, A)
    d, r = U.shape[-2:]
    n = A.shape[-1]
    stack = _common_stack((U, 2), (A, 2))
    C, P = _bp.brand_panel_batched(_flat(U, 2, stack), _flat(A, 2, stack))
    return (C.to(U.dtype).reshape(stack + (r, n)),
            P.to(A.dtype).reshape(stack + (d, n)))


def ut_a(U: Tensor, A: Tensor) -> Tensor:
    """C = UᵀA — the first launch of ``brand_panel`` alone (a row-block
    Brand update sums it over the model axis before ``a_perp``).
    U: (*stack, d, r), A: (*stack, d, n)."""
    if not A.is_cuda:
        return ref.ut_a(U, A)
    r, n = U.shape[-1], A.shape[-1]
    stack = _common_stack((U, 2), (A, 2))
    C = _bp.ut_a_batched(_flat(U, 2, stack), _flat(A, 2, stack))
    return C.to(U.dtype).reshape(stack + (r, n))


def a_perp(A: Tensor, U: Tensor, C: Tensor) -> Tensor:
    """A⊥ = A − U C — the second launch of ``brand_panel`` alone.
    A: (*stack, d, n), U: (*stack, d, r), C: (*stack, r, n)."""
    if not A.is_cuda:
        return ref.a_perp(A, U, C)
    d, n = A.shape[-2:]
    stack = _common_stack((A, 2), (U, 2), (C, 2))
    P = _bp.a_perp_batched(_flat(A, 2, stack), _flat(U, 2, stack),
                           _flat(C, 2, stack))
    return P.to(A.dtype).reshape(stack + (d, n))


def syrk_tn(A: Tensor) -> Tensor:
    """G = AᵀA in fp32 — the Gram pass of ``cholqr2`` alone (a row-block
    QR sums it over the model axis).  A: (*stack, d, n)."""
    if not A.is_cuda:
        return ref.syrk_tn(A)
    n = A.shape[-1]
    stack = _common_stack((A, 2))
    return _cq.syrk_tn_batched(_flat(A, 2, stack)).reshape(stack + (n, n))


def rinv_apply(A: Tensor, Rinv: Tensor) -> Tensor:
    """Q = A Rinv — the apply pass of ``cholqr2`` alone, in A's dtype.
    A: (*stack, d, n), Rinv: (*stack, n, n)."""
    if not A.is_cuda:
        return ref.rinv_apply(A, Rinv)
    d, n = A.shape[-2:]
    stack = _common_stack((A, 2), (Rinv, 2))
    Q = _cq.rinv_apply_batched(_flat(A, 2, stack), _flat(Rinv, 2, stack))
    return Q.to(A.dtype).reshape(stack + (d, n))


def cholqr2(A: Tensor) -> Tuple[Tensor, Tensor]:
    """Tall-skinny QR  A ≈ Q R  by CholeskyQR2 with a clamped spectral
    root.  A: (*stack, d, n) → Q (*stack, d, n) in A.dtype, R (*stack, n,
    n) symmetric psd float32."""
    if not A.is_cuda:
        return ref.cholqr2(A)
    d, n = A.shape[-2:]
    stack = _common_stack((A, 2))
    Q, R = _cq.cholqr2_batched(_flat(A, 2, stack))
    return (Q.to(A.dtype).reshape(stack + (d, n)),
            R.reshape(stack + (n, n)))


def orthonormalize(Y: Tensor) -> Tensor:
    """Orthonormal basis of range(Y) via CholeskyQR2 — the Q-only entry
    point of the RSVD range finder."""
    return cholqr2(Y)[0]


def lowrank_apply(X: Tensor, U: Tensor, s: Tensor, lam) -> Tensor:
    """Y = (X U) diag(s) Uᵀ + X/λ.
    X: (*stack, p, d), U: (*stack, d, w), s: (*stack, w), lam: scalar or
    (*stack,).  A transposed X (the left application's view of a stack
    with contiguous rows) goes to the kernel as it lies, and Y comes back
    the same way, a transposed view of a contiguous (*stack, d, p): neither
    is copied.  X is copied to contiguous rows only where its stack axes
    do not flatten into one batch stride (``reshape`` copies: a slice or a
    broadcast across one of two or more stack axes) or neither its rows nor
    its columns are contiguous."""
    if not X.is_cuda:
        return ref.lowrank_apply(X, U, s, lam)
    p, d = X.shape[-2:]
    stack = _common_stack((X, 2), (U, 2), (s, 1))
    Xb = _flat(X, 2, stack, columns=True)
    ilam = 1.0 / _stack_lam(lam, stack, Xb.shape[0], X)
    out = _la.lowrank_apply_batched(Xb, _flat(U, 2, stack),
                                    _flat(s, 1, stack).contiguous(), ilam)
    return out.to(X.dtype).reshape(stack + (p, d))


def precond_fused(J: Tensor, U_g: Tensor, s_g: Tensor, lam_g,
                  U_a: Tensor, s_a: Tensor, lam_a) -> Tensor:
    """S = Γ̄⁻¹ J Ā⁻¹ — the full two-sided application.

    J: (*stack, p, d), U_g: (*stack, p, w_g), s_g: (*stack, w_g),
    U_a: (*stack, d, w_a), s_a: (*stack, w_a); λ's scalar or (*stack,).
    """
    if not J.is_cuda:
        return ref.precond_fused(J, U_g, s_g, lam_g, U_a, s_a, lam_a)
    p, d = J.shape[-2:]
    stack = _common_stack((J, 2), (U_g, 2), (U_a, 2), (s_g, 1), (s_a, 1))
    Jb = _flat(J, 2, stack)
    b = Jb.shape[0]
    sgb = _flat(s_g, 1, stack).contiguous()
    sab = _flat(s_a, 1, stack).contiguous()
    ilam_g = 1.0 / _stack_lam(lam_g, stack, b, J)
    ilam_a = 1.0 / _stack_lam(lam_a, stack, b, J)
    out = _pf.precond_fused_batched(Jb, _flat(U_g, 2, stack), sgb, ilam_g,
                                    _flat(U_a, 2, stack), sab, ilam_a)
    return out.to(J.dtype).reshape(stack + (p, d))


def precond_panel(U_g: Tensor, J: Tensor, s_g: Tensor) -> Tensor:
    """Cg = diag(s_g) U_gᵀ J — the panel launch of ``precond_fused`` alone
    (on row blocks it is summed over the model axis before
    ``precond_apply``).  U_g: (*stack, p, w_g), J: (*stack, p, d),
    s_g: (*stack, w_g) → (*stack, w_g, d) fp32."""
    if not J.is_cuda:
        return ref.precond_panel(U_g, J, s_g)
    d, w_g = J.shape[-1], U_g.shape[-1]
    stack = _common_stack((U_g, 2), (J, 2), (s_g, 1))
    Cg = _pf.precond_panel_batched(_flat(U_g, 2, stack), _flat(J, 2, stack),
                                   _flat(s_g, 1, stack).contiguous())
    return Cg.reshape(stack + (w_g, d))


def precond_apply(J: Tensor, U_g: Tensor, Cg: Tensor, U_a: Tensor,
                  s_a: Tensor, lam_g, lam_a) -> Tensor:
    """S = (W U_a) diag(s_a) U_aᵀ + W/λ_a with W = U_g Cg + J/λ_g — the
    apply launch of ``precond_fused`` alone.  J: (*stack, p, d), U_g:
    (*stack, p, w_g), Cg: (*stack, w_g, d), U_a: (*stack, d, w_a), s_a:
    (*stack, w_a); λ's scalar or (*stack,)."""
    if not J.is_cuda:
        return ref.precond_apply(J, U_g, Cg, U_a, s_a, lam_g, lam_a)
    p, d = J.shape[-2:]
    stack = _common_stack((J, 2), (U_g, 2), (Cg, 2), (U_a, 2), (s_a, 1))
    Jb = _flat(J, 2, stack)
    b = Jb.shape[0]
    out = _pf.precond_apply_batched(
        Jb, _flat(U_g, 2, stack), _flat(Cg, 2, stack), _flat(U_a, 2, stack),
        _flat(s_a, 1, stack).contiguous(),
        1.0 / _stack_lam(lam_g, stack, b, J),
        1.0 / _stack_lam(lam_a, stack, b, J))
    return out.to(J.dtype).reshape(stack + (p, d))
