"""Gradient compression for the DP all-reduce (PowerSGD-style low-rank with
error feedback, Vogels et al. 2019).

Counterpart of ``src/repro/distributed/compress.py``.  For a gradient
matrix G (m, n), rank-q compression reduces P = G Q (m, q) and
Q' = Gᵀ P (n, q) instead of G — a (m+n)·q / (m·n) volume reduction — and
the residual is fed back into the next step's gradient (error feedback
keeps SGD convergent).  ``compress_tree`` applies this to every ≥2D leaf
above a size threshold; small leaves pass through.  On one device nothing
is reduced; across the ranks of a data mesh the products are summed as
below.

As the reference: every leading axis folds into rows (``_as_matrix``: a
stacked LM weight (repeats, d, d') is one (repeats·d, d') matrix);
orthonormalisation is Householder QR (``torch.linalg.qr``, the
reference's ``jnp.linalg.qr``; see ``compress`` for why not CholeskyQR2);
and the returned error is ``g − P Qᵀ`` where the docstring above would
have ``(g + err) − P Qᵀ`` — the reference's code, mirrored.

**Across ranks** (a data-parallel policy ``sp``, whose ranks each hold
their share g_r of the global mean gradient g = Σ_r g_r, and their own
error-feedback term e_r): a round folds M_r = g_r + e_r, and every
product with M is a sum over the ranks of the products with M_r —
P = Σ_r M_r Q, then Mᵀ P̂ = Σ_r M_rᵀ P̂ — each all-reduced over the data
axes before the next step uses it (the QR factorisations run on the
reduced, identical panels on every rank).  The seeded basis Q is the same
on every rank, so each step is linear in M given the shared panels, and
the ranks end with the P̂ Qᵀ of M = Σ_r M_r: the reference's compression
of g + e, up to the order of the summation.  Each rank keeps
e_r ← g_r − P̂ Qᵀ / N, whose sum over the ranks is the reference's
``g − P Qᵀ`` (its quirk, below, mirrored), so by induction Σ_r e_r is
the reference's error at every step.  Leaves the compressor leaves whole
are summed raw.

**Tensor parallelism** (a model axis larger than 1; ``sp.shards`` says
which leaves a rank holds a block of): the reference compresses the
*whole* leaf, so every product with M is again a sum of the blocks'
products.  A leaf split over its last dimension (column blocks M_s, the
folded matrix's columns) has P = M Q = Σ_s M_s Q_s, summed over the
model axis as well as the data axes, and Q = Mᵀ P̂ is row-local: each
rank keeps the rows of Q (and of the seeded basis) of its columns.  A
leaf split over an earlier dimension (row blocks of the folded matrix,
an (E,)-stack's experts or a fan-in's rows under each stacked repeat)
has P's rows local: they are summed over the data axes and gathered over
the model axis before the QR, which then runs on the whole, identical P
everywhere, and Q = Σ_s M_sᵀ P̂_s is summed over every axis.  The rank's
block of the approximation is P̂_s Qᵀ (column split: P̂ Q_sᵀ), its error
its block of the reference's.  Whether a leaf is compressed goes by its
whole size, as in the reference.

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


def _split(sp, key: Optional[str], g: Tensor):
    """(the whole leaf's shape, its dimension on the model axis or None)
    of ``g``, this rank's part of leaf ``key``."""
    if key is None or sp is None or not sp.model_parallel:
        return tuple(g.shape), None
    return sp.shards.shapes[key], sp.shards.dim(key)


def _round(g: Tensor, err: Tensor, q_prev: Optional[Tensor], cfg,
           basis: Optional[Tensor] = None, sp=None, consume: bool = False,
           key: Optional[str] = None):
    """One compression round → (P, Q, new_err, approx); ``approx`` is
    ``decompress(P, Q, g.shape)`` bit for bit (made once, after the
    folded matrix is freed).  With a data-parallel ``sp``, ``g`` and
    ``err`` are this rank's and every product with the folded matrix is
    summed over the data axes (module docstring).  ``consume``: ``err``
    (fp32) is the round's to overwrite — the folded matrix and then the
    new error are made in its storage, the same numbers with two fewer
    temporaries of the leaf's size."""
    dp = sp is not None and sp.data_parallel
    red = sp.dp_sum if dp else (lambda x: x)
    whole, tdim = _split(sp, key, g)
    if tdim is not None:
        return _round_tp(g, err, q_prev, cfg, basis, sp, consume, whole,
                         tdim, red)
    g32 = g.to(torch.float32)
    if consume and err.dtype == torch.float32 and err.is_contiguous():
        G2, shape = _as_matrix(err.add_(g32))         # g + err, in place
    else:
        consume = False
        G2, shape = _as_matrix(g32 + err.to(torch.float32))
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
    P = red(G2 @ q_prev)                              # (m, q)
    for _ in range(cfg.n_power_iter):
        P, _ = torch.linalg.qr(P)
        P = red(G2 @ red(G2.T @ P))
    P, _ = torch.linalg.qr(P)                         # orthonormal basis
    Q = red(G2.T @ P)                                 # (n, q)
    del G2
    approx = decompress(P, Q, shape)
    # the new error g − P Qᵀ (this rank's share of it: P Qᵀ / N)
    out = err if consume else None
    if dp:
        new_err = torch.sub(g32, approx, alpha=1.0 / sp.dp_size, out=out)
    else:
        new_err = torch.sub(g32, approx, out=out)
    return P, Q, new_err, approx


def _round_tp(g, err, q_prev, cfg, basis, sp, consume, whole, tdim, red):
    """:func:`_round` of a leaf split over the model axis (module
    docstring): ``whole`` its shape, ``tdim`` its dimension on the
    axis."""
    from repro_torch.distributed import collectives as coll
    red_all = lambda x: coll.all_reduce(x, sp.mesh, None)
    g32 = g.to(torch.float32)
    if consume and err.dtype == torch.float32 and err.is_contiguous():
        G2, shape = _as_matrix(err.add_(g32))
    else:
        consume = False
        G2, shape = _as_matrix(g32 + err.to(torch.float32))
    m_all, n_all = _as_matrix(torch.empty(whole, device="meta"))[0].shape
    q = min(cfg.rank, m_all, n_all)
    cols = tdim == len(whole) - 1
    n = G2.shape[1]
    if q_prev is None or tuple(q_prev.shape) != (n, q):
        q_prev = basis if basis is not None else seeded_basis(
            m_all, n_all, q, G2.device)
        if cols and q_prev.shape[0] != n:
            q_prev = sp.block(q_prev, 0)
    q_prev = q_prev.to(G2.device, torch.float32)
    lead = tuple(g.shape[:-1])

    def gather_rows(P):             # local P rows → the whole P
        P = coll.all_gather(P.reshape(lead + (q,)), sp.mesh, sp.tp, tdim)
        return P.reshape(m_all, q)

    def rows(P):                    # the rank's rows of a whole P
        return sp.block(P.reshape(tuple(whole[:-1]) + (q,)), tdim
                        ).reshape(-1, q)

    if cols:
        P = red_all(G2 @ q_prev)
        for _ in range(cfg.n_power_iter):
            P, _ = torch.linalg.qr(P)
            P = red_all(G2 @ red(G2.T @ P))
        P, _ = torch.linalg.qr(P)
        Q = red(G2.T @ P)                               # the rank's rows
        del G2
        approx = decompress(P, Q, shape)
    else:
        P = gather_rows(red(G2 @ q_prev))
        for _ in range(cfg.n_power_iter):
            P, _ = torch.linalg.qr(P)
            P = gather_rows(red(G2 @ red_all(G2.T @ rows(P))))
        P, _ = torch.linalg.qr(P)
        Q = red_all(G2.T @ rows(P))
        del G2
        approx = decompress(rows(P), Q, shape)
    out = err if consume else None
    alpha = 1.0 / sp.dp_size if sp.data_parallel else 1.0
    new_err = torch.sub(g32, approx, alpha=alpha, out=out)
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


def _compressible(g: Tensor, cfg: CompressConfig, sp=None,
                  key: Optional[str] = None) -> bool:
    shape, _ = _split(sp, key, g)
    return len(shape) >= 2 and np_prod(shape) >= cfg.min_size


def _cold_q(g: Tensor, cfg: CompressConfig,
            basis: Optional[Tensor] = None, sp=None,
            key: Optional[str] = None) -> Tensor:
    """The deterministic seeded basis :func:`compress` cold-starts from —
    the *initial* warm-start carry, so round 1 of the stateful path is
    the stateless cold start (a leaf split over its last dimension on a
    model axis keeps the rows of its columns)."""
    shape, tdim = _split(sp, key, g)
    m = shape[0] if len(shape) == 2 else np_prod(shape[:-1])
    n = shape[-1]
    q = min(cfg.rank, m, n)
    if basis is None:
        basis = seeded_basis(m, n, q, g.device)
    basis = basis.to(g.device, torch.float32)
    if tdim == len(shape) - 1:
        basis = sp.block(basis, 0)
    return basis


def init_errors(params: Mapping[str, Tensor]) -> Dict[str, Tensor]:
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in params.items()}


def init_state(params: Mapping[str, Tensor], cfg: CompressConfig,
               bases: Optional[Mapping[str, Tensor]] = None, sp=None
               ) -> CompressState:
    """Fresh compressor carry: zero error feedback + the seeded cold-start
    basis per compressible leaf (``bases[k]`` where given), a zero-size
    sentinel otherwise.  Under tensor parallelism ``params`` are the
    rank's blocks and ``sp`` the LM's policy."""
    bases = bases or {}
    q = {k: (_cold_q(p, cfg, bases.get(k), sp, k)
             if _compressible(p, cfg, sp, k)
             else torch.zeros((0,), dtype=torch.float32, device=p.device))
         for k, p in params.items()}
    return CompressState(err=init_errors(params), q=q)


def compress_tree(grads: Dict[str, Tensor], state: CompressState,
                  cfg: CompressConfig, sp=None
                  ) -> Tuple[Dict[str, Tensor], CompressState]:
    """Error-feedback low-rank compression leaf by leaf, threading each
    leaf's warm-start Q through ``state`` → (approx_grads, new_state).

    It consumes its inputs, as the port's other in-place paths do: each
    leaf is taken out of ``grads``, ``state.err`` and ``state.q`` as it is
    done, so the raw gradient and the old error of a leaf are freed before
    the next leaf's round (at billions of parameters the step cannot hold
    two more copies of them).  Keep the returned values; the ones passed
    in are left empty.  The numbers are the reference's.

    With a data-parallel ``sp`` the gradients are this rank's shares and
    the approximations come back summed over the data axes (the leaves
    left whole summed raw): the reduced gradient of the module
    docstring.  Under tensor parallelism ``sp`` is the LM's policy, a
    sharded leaf's gradient is the rank's block (its approximation too)
    and a replicated leaf's is already summed over the model axis
    (``kfac_grads(reduce_grads=False)``)."""
    approx: Dict[str, Tensor] = {}
    err: Dict[str, Tensor] = {}
    q: Dict[str, Tensor] = {}
    whole = []
    for k in list(grads):
        g, e, qp = grads.pop(k), state.err.pop(k), state.q.pop(k)
        if not _compressible(g, cfg, sp, k):
            whole.append(g)
            approx[k], err[k], q[k] = g, torch.zeros_like(e), qp
            continue
        _, Q, new_err, a = _round(g, e, qp if qp.numel() else None, cfg,
                                  sp=sp, consume=True, key=k)
        approx[k], err[k], q[k] = a.to(g.dtype), new_err, Q
        del g, e
    if sp is not None:
        sp.dp_sum_all(whole)
    return approx, CompressState(err=err, q=q)
