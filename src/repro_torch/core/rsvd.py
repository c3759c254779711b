"""Randomized low-rank decompositions (Halko–Martinsson–Tropp) — the
R-KFAC substrate the paper builds on.

Counterpart of ``src/repro/core/rsvd.py``: ``range_finder``, ``rsvd_psd``
and ``exact_evd``, stacked-native (the reference vmaps them over a
bucket's slots; here a bucket is one batched call).  The Gaussian test
matrix is drawn from an explicit ``torch.Generator`` unless the caller
injects it as ``omega`` (the parity tests inject the reference's draws).
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from repro_torch.kernels.ref import eigh, mt as _mt

Tensor = torch.Tensor


def range_finder(matvec: Callable[[Tensor], Tensor], d: int, k: int,
                 n_iter: int, *, omega: Optional[Tensor] = None,
                 generator: Optional[torch.Generator] = None,
                 stack: Tuple[int, ...] = (), dtype=torch.float32,
                 device=None) -> Tensor:
    """Orthonormal basis Q (*stack, d, k) approximately spanning range(M).

    ``matvec`` maps (*stack, d, k) → (*stack, d, k).  Subspace iteration
    with re-orthonormalization each pass by CholeskyQR2
    (``ops.orthonormalize``: the kernel pair on the card)."""
    from repro_torch.kernels import ops as kops
    if omega is None:
        omega = torch.randn(tuple(stack) + (d, k), generator=generator,
                            dtype=dtype, device=device)
    Q = kops.orthonormalize(matvec(omega))
    for _ in range(n_iter):
        Q = kops.orthonormalize(matvec(Q))
    return Q


def _pad_modes(U: Tensor, D: Tensor, pad_to: Optional[int]
               ) -> Tuple[Tensor, Tensor]:
    w = U.shape[-1]
    if pad_to is None or pad_to <= w:
        return U, D
    U = torch.cat([U, U.new_zeros(U.shape[:-1] + (pad_to - w,))], dim=-1)
    D = torch.cat([D, D.new_zeros(D.shape[:-1] + (pad_to - w,))], dim=-1)
    return U, D


def rsvd_psd(M: Tensor, r: int, r_o: int, n_iter: int = 2,
             pad_to: Optional[int] = None, *, omega: Optional[Tensor] = None,
             generator: Optional[torch.Generator] = None
             ) -> Tuple[Tensor, Tensor]:
    """Randomized EVD of symmetric psd M (*stack, d, d), target rank r.

    Returns (U, D): U (*stack, d, r) orthonormal, D (*stack, r) descending,
    zero-padded to ``pad_to`` modes when given."""
    d = M.shape[-1]
    k = min(r + r_o, d)
    Q = range_finder(lambda Y: M @ Y, d, k, n_iter, omega=omega,
                     generator=generator, stack=M.shape[:-2],
                     dtype=M.dtype, device=M.device)
    B = _mt(Q) @ (M @ Q)
    B = 0.5 * (B + _mt(B))
    vals, vecs = eigh(B)
    vals, vecs = vals.flip(-1), vecs.flip(-1)
    U = Q @ vecs[..., :, :r]
    D = torch.clamp(vals[..., :r], min=0.0)
    return _pad_modes(U, D, pad_to)


def exact_evd(M: Tensor, r: Optional[int] = None,
              pad_to: Optional[int] = None) -> Tuple[Tensor, Tensor]:
    """Dense EVD (the K-FAC baseline inverse path), descending, optionally
    truncated to rank r and zero-padded to a static width."""
    vals, vecs = eigh(0.5 * (M + _mt(M)))
    vals, vecs = vals.flip(-1), vecs.flip(-1)
    if r is not None:
        vals, vecs = vals[..., :r], vecs[..., :, :r]
    return _pad_modes(vecs, vals, pad_to)
