"""Gradient compression for the DP all-reduce (PowerSGD-style low-rank with
error feedback, Vogels et al. 2019).

Counterpart of ``src/repro/distributed/compress.py``.  For a gradient
matrix G (m, n), rank-q compression reduces P = G Q (m, q) and
Q' = Gᵀ P (n, q) instead of G — a (m+n)·q / (m·n) volume reduction — and
the residual is fed back into the next step's gradient (error feedback
keeps SGD convergent).  ``compress_tree`` applies this to every ≥2D leaf
above a size threshold; small leaves pass through.  On one device nothing
is reduced: this module only reshapes what would enter the collective.

As the reference: every leading axis folds into rows (``_as_matrix``: a
stacked LM weight (repeats, d, d') is one (repeats·d, d') matrix);
orthonormalisation is Householder QR (``torch.linalg.qr``, the
reference's ``jnp.linalg.qr``; see ``compress`` for why not CholeskyQR2);
and the returned error is ``g − P Qᵀ`` where the docstring above would
have ``(g + err) − P Qᵀ`` — the reference's code, mirrored.

The seeded bases (the reference's ``jax.random.normal(PRNGKey(m ·
1315423911 + n), (n, q))``) come from a CPU ``torch.Generator`` seeded
with the same integer (the same on every device); their numbers are not
the reference's, so ``compress``, ``compress_batched`` and ``init_state`` take
the basis as an optional argument and parity tests inject the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Tuple

import torch

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class CompressConfig:
    rank: int = 8
    min_size: int = 65536       # leaves smaller than this stay dense
    n_power_iter: int = 1


def np_prod(xs) -> int:
    out = 1
    for x in xs:
        out *= int(x)
    return out


def _as_matrix(g: Tensor) -> Tuple[Tensor, Tuple[int, ...]]:
    shape = tuple(g.shape)
    m = shape[0] if g.dim() == 2 else np_prod(shape[:-1])
    return g.reshape(m, shape[-1]), shape


def seeded_basis(m: int, n: int, q: int, device=None) -> Tensor:
    """The deterministic (n, q) cold-start basis of an (m, n) matrix: a
    normal draw from a CPU generator seeded per shape, moved to
    ``device`` — the same numbers on every device, as the reference's
    key-based draw."""
    g = torch.Generator().manual_seed(m * 1315423911 + n)
    return torch.randn((n, q), generator=g).to(device)


def _round(g: Tensor, err: Tensor, q_prev: Optional[Tensor], cfg,
           basis: Optional[Tensor] = None):
    """One compression round → (P, Q, new_err, approx); ``approx`` is
    ``decompress(P, Q, g.shape)`` bit for bit (made once, after the
    folded matrix is freed)."""
    G2, shape = _as_matrix(g.to(torch.float32) + err.to(torch.float32))
    m, n = G2.shape
    q = min(cfg.rank, m, n)
    if q_prev is None or tuple(q_prev.shape) != (n, q):
        # warm start: deterministic basis (seeded per shape)
        q_prev = (basis if basis is not None
                  else seeded_basis(m, n, q, G2.device))
    q_prev = q_prev.to(G2.device, torch.float32)
    # Orthonormalisation stays Householder, as in the reference: PowerSGD
    # relies on QR's arbitrary orthonormal completion (columns the power
    # iteration has not aligned still pick up signal through Q = G2ᵀP),
    # where a spectral factorisation such as CholeskyQR2 maps them to an
    # exactly-null subspace and wastes the rank; these (m, ≤ 8) panels
    # are far too thin for a batched kernel launch anyway.
    P = G2 @ q_prev                                   # (m, q)
    for _ in range(cfg.n_power_iter):
        P, _ = torch.linalg.qr(P)
        P = G2 @ (G2.T @ P)
    P, _ = torch.linalg.qr(P)                         # orthonormal basis
    Q = G2.T @ P                                      # (n, q)
    del G2
    approx = decompress(P, Q, shape)
    new_err = g.to(torch.float32) - approx
    return P, Q, new_err, approx


def compress(g: Tensor, err: Tensor, q_prev: Optional[Tensor], cfg,
             basis: Optional[Tensor] = None) -> Tuple[Tensor, Tensor, Tensor]:
    """→ (P, Q, new_error).  A caller would reduce P (and Q on odd
    rounds).  ``q_prev`` of the wrong shape, or None, cold-starts from
    ``basis`` when given (the parity tests' reference draw), else from
    :func:`seeded_basis`."""
    P, Q, new_err, _ = _round(g, err, q_prev, cfg, basis)
    return P, Q, new_err


def decompress(P: Tensor, Q: Tensor, shape: Tuple[int, ...]) -> Tensor:
    return (P @ Q.T).reshape(shape)


def compress_batched(G: Tensor, rank: int, n_power_iter: int = 1,
                     basis: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
    """Memoryless batched PowerSGD projection (the reference's curvature
    engine's (U, λ) collective path): G (*stack, m, n) → P (*stack, m, q),
    Q (*stack, n, q) with q = min(rank, m, n); every member decompresses
    with ``P @ Qᵀ``.  No error feedback: each round re-projects the exact
    current state.  The basis is :func:`compress`'s cold-start one for
    (m, n), shared by the whole stack (``basis`` injects it)."""
    m, n = G.shape[-2:]
    q = min(int(rank), m, n)
    if basis is None:
        basis = seeded_basis(m, n, q, G.device)
    basis = basis.to(G.device, G.dtype)
    GT = G.transpose(-1, -2)
    P = G @ basis
    for _ in range(n_power_iter):
        P = torch.linalg.qr(P)[0]
        P = G @ (GT @ P)
    P = torch.linalg.qr(P)[0]
    Q = GT @ P
    return P, Q


@dataclasses.dataclass
class CompressState:
    """Per-leaf carry of the error-feedback compressor: ``err`` is the
    residual fed back into the next round, ``q`` the previous round's Q
    factor — PowerSGD's warm start, which lets the single power iteration
    keep sharpening the rank-q basis across rounds.  Leaves that stay
    uncompressed carry a zero-size ``q`` sentinel, as in the reference.
    Both are flat dicts keyed like the parameters."""
    err: Dict[str, Tensor]
    q: Dict[str, Tensor]


def _compressible(g: Tensor, cfg: CompressConfig) -> bool:
    return g.dim() >= 2 and g.numel() >= cfg.min_size


def _cold_q(g: Tensor, cfg: CompressConfig,
            basis: Optional[Tensor] = None) -> Tensor:
    """The deterministic seeded basis :func:`compress` cold-starts from —
    the *initial* warm-start carry, so round 1 of the stateful path is
    the stateless cold start."""
    shape = tuple(g.shape)
    m = shape[0] if g.dim() == 2 else np_prod(shape[:-1])
    n = shape[-1]
    q = min(cfg.rank, m, n)
    if basis is not None:
        return basis.to(g.device, torch.float32)
    return seeded_basis(m, n, q, g.device)


def init_errors(params: Mapping[str, Tensor]) -> Dict[str, Tensor]:
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in params.items()}


def init_state(params: Mapping[str, Tensor], cfg: CompressConfig,
               bases: Optional[Mapping[str, Tensor]] = None
               ) -> CompressState:
    """Fresh compressor carry: zero error feedback + the seeded cold-start
    basis per compressible leaf (``bases[k]`` where given), a zero-size
    sentinel otherwise."""
    bases = bases or {}
    q = {k: (_cold_q(p, cfg, bases.get(k)) if _compressible(p, cfg)
             else torch.zeros((0,), dtype=torch.float32, device=p.device))
         for k, p in params.items()}
    return CompressState(err=init_errors(params), q=q)


def compress_tree(grads: Dict[str, Tensor], state: CompressState,
                  cfg: CompressConfig) -> Tuple[Dict[str, Tensor],
                                                CompressState]:
    """Error-feedback low-rank compression leaf by leaf, threading each
    leaf's warm-start Q through ``state`` → (approx_grads, new_state).

    It consumes its inputs, as the port's other in-place paths do: each
    leaf is taken out of ``grads``, ``state.err`` and ``state.q`` as it is
    done, so the raw gradient and the old error of a leaf are freed before
    the next leaf's round (at billions of parameters the step cannot hold
    two more copies of them).  Keep the returned values; the ones passed
    in are left empty.  The numbers are the reference's."""
    approx: Dict[str, Tensor] = {}
    err: Dict[str, Tensor] = {}
    q: Dict[str, Tensor] = {}
    for k in list(grads):
        g, e, qp = grads.pop(k), state.err.pop(k), state.q.pop(k)
        if not _compressible(g, cfg):
            approx[k], err[k], q[k] = g, torch.zeros_like(e), qp
            continue
        _, Q, new_err, a = _round(g, e, qp if qp.numel() else None, cfg)
        approx[k], err[k], q[k] = a.to(g.dtype), new_err, Q
        del g, e
    return approx, CompressState(err=err, q=q)
