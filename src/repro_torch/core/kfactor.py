"""EA K-factor state and its update modes — the heart of the paper.

Counterpart of ``src/repro/core/kfactor.py``.  A K-factor is the
exponential average  M_k = ρ M_{k-1} + (1-ρ) X_k X_kᵀ  (paper eq. 5/8);
each optimizer variant is a choice of how the *inverse representation*
(U, D) of M is maintained:

  mode        holds M?   update of (U, D)                         paper
  EVD         yes        dense eigh of M every T_inv              K-FAC
  RSVD        yes        rsvd_psd(M) every T_inv                  R-KFAC
  BRAND       no         ea_brand_step every T_brand              B-KFAC
  BRAND_RSVD  yes        Brand + RSVD overwrite every T_rsvd      B-R-KFAC
  BRAND_CORR  yes        Brand + light correction every T_corct   B-KFAC-C
  NS          yes        Newton–Schulz refinement of the held     NS-KFAC
                         dense inverse every T_inv (matmul-only)

Every operation is stacked-native over leading batch axes.  The random
inputs of the heavy ops — the RSVD test matrix ``omega`` and the Alg-6
column choice ``idx`` — are drawn from a ``torch.Generator`` or injected
by the caller (``heavy_overwrite_batched(draws=...)``).

The async heavy pipeline (``InflightState`` … ``bucket_factor_step_async``,
reference ``core/kfactor.py:451-650``) keeps one deliberate difference
from the reference: **draws are snapshotted, not keys.**  The reference
snapshots per-slot PRNG keys and its heavy op redraws from them when it
lands; the port has no ``jax.random``, so a launch stores the launch
step's *draws* (the RSVD test matrices or the correction's columns),
taken from the same generator in the same order as the synchronous path
takes them on that step.  ``heavy_from_snapshot`` then draws nothing: it
is a pure function of the buffer, which both the overlapped landing (a
worker thread, on the card a side stream) and the in-graph landing need.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.core import brand, rsvd
from repro_torch.kernels.ref import eigh
from repro_torch.obs import trace as obs_trace

Tensor = torch.Tensor


class Mode(enum.Enum):
    EVD = "evd"
    RSVD = "rsvd"
    BRAND = "brand"
    BRAND_RSVD = "brand_rsvd"
    BRAND_CORR = "brand_corr"
    NS = "ns"


_NEEDS_M = {Mode.EVD, Mode.RSVD, Mode.BRAND_RSVD, Mode.BRAND_CORR, Mode.NS}
_HAS_BRAND = {Mode.BRAND, Mode.BRAND_RSVD, Mode.BRAND_CORR}

#: channels of KFactorState.aux — heavy-op diagnostics, never read by the
#: update math
AUX_LAM = 0
AUX_RES = 1
AUX_TRUNC = 2   # EVD/RSVD overwrites: truncated spectral-mass fraction
AUX_WIDTH = 3

@dataclasses.dataclass
class KFactorState:
    """Inverse representation of one EA K-factor (or a stack of them).

    U: (…, d, width) column-orthonormal; D: (…, width) descending (NS: U
    is the dense damped inverse and D is all-zero);
    M: (…, d, d) dense EA factor or a (…, 1, 1) placeholder for pure
    Brand; aux: (…, AUX_WIDTH) diagnostics."""
    U: Tensor
    D: Tensor
    M: Tensor
    aux: Tensor

    def map(self, fn) -> "KFactorState":
        return KFactorState(U=fn(self.U), D=fn(self.D), M=fn(self.M),
                            aux=fn(self.aux))


def make_state(d: int, width: int, needs_m: bool, dtype=torch.float32,
               device=None) -> KFactorState:
    m_shape = (d, d) if needs_m else (1, 1)
    z = lambda *s: torch.zeros(s, dtype=dtype, device=device)
    return KFactorState(U=z(d, width), D=z(width), M=z(*m_shape),
                        aux=z(AUX_WIDTH))


@dataclasses.dataclass(frozen=True)
class KFactorSpec:
    """Static description of one K-factor's update policy."""
    d: int
    r: int
    n_stat: int
    mode: Mode
    rho: float = 0.95
    r_o: int = 10
    n_pwr_iter: int = 2
    n_crc: int = 0
    ns_iters: int = 8
    ns_phi: float = 0.1
    ns_guard: float = 0.9

    @property
    def width(self) -> int:
        if self.mode is Mode.NS:
            return self.d
        if self.mode in _HAS_BRAND:
            return min(self.r + self.n_stat, self.d)
        return min(self.r, self.d)

    @property
    def needs_m(self) -> bool:
        return self.mode in _NEEDS_M

    def init(self, dtype=torch.float32, device=None) -> KFactorState:
        return make_state(self.d, self.width, self.needs_m, dtype, device)


# ---------------------------------------------------------------------------
# individual update operations (stacked; X is (…, d, n_stat))
# ---------------------------------------------------------------------------

def ea_update_m(M: Tensor, X: Tensor, rho: float, first: bool) -> Tensor:
    """M ← ρ M + (1-ρ) X Xᵀ  (κ(0)=1 on the first-ever update, eq. 5)."""
    coef = 1.0 if first else 1.0 - rho
    keep = 0.0 if first else rho
    return keep * M + coef * (X @ X.transpose(-1, -2))


def ea_update_m_kernel(M: Tensor, X: Tensor, rho: float, first: bool
                       ) -> Tensor:
    """Same as ea_update_m through ``ops.ea_syrk``: the EA-SYRK kernel on
    the card, its plain version on the CPU."""
    from repro_torch.kernels import ops as kops
    return kops.ea_syrk(M, X, rho, first)


def ea_update_m_rows(M_rows: Tensor, X: Tensor, r0: int, rb: int,
                     rho: float, first: bool) -> Tensor:
    """Row block [r0, r0+rb) of the EA absorb, exactly: every element of
    X Xᵀ is an independent full-length dot product, so the row slice of
    the absorb equals the absorb of the row slice (reference
    ``core/kfactor.py:149``).  This is what lets the 2D curvature engine
    keep the dense M row-sharded through stats steps.

    M_rows: (*stack, rb, d) local row block; X: (*stack, d, n), whole on
    every row member.  The coefficients are ``kernels/ref.py::ea_syrk``'s;
    the product is one batched matmul outside any kernel, as the
    reference computes it outside Pallas."""
    X_rows = X[..., r0:r0 + rb, :]
    rho_t = torch.as_tensor(rho, dtype=M_rows.dtype, device=M_rows.device)
    firstf = torch.as_tensor(float(first), dtype=M_rows.dtype,
                             device=M_rows.device)
    keep = rho_t * (1.0 - firstf)
    coef = 1.0 - keep
    upd = (X_rows @ X.transpose(-1, -2)).to(M_rows.dtype)
    return keep * M_rows + coef * upd


def brand_step(spec: KFactorSpec, st: KFactorState, X: Tensor, first: bool,
               use_kernel: bool = False) -> KFactorState:
    """B-update (Alg 4): on the first-ever stats batch initialise from the
    factor; otherwise truncate to r, then the symmetric Brand update with
    the EA term.  ``first`` is a Python bool (the step counters live on
    the host)."""
    if first:
        U, D = brand.init_from_factor(X, spec.width)
    else:
        U, D = brand.ea_brand_step(st.U, st.D, X, spec.rho, spec.r,
                                   use_kernel=use_kernel)
        if U.shape[-1] > spec.width:  # r + n_stat exceeded d: re-truncate
            U, D = U[..., :, :spec.width], D[..., :spec.width]
    return KFactorState(U=U, D=D, M=st.M, aux=st.aux)


def _trunc_mass_aux(aux: Tensor, M: Tensor, D: Tensor) -> Tensor:
    """AUX_TRUNC ← max(0, tr M − Σ retained D) / tr M (diagnostic)."""
    tr = torch.diagonal(M, dim1=-2, dim2=-1).sum(-1)
    kept = D.sum(-1)
    frac = torch.clamp(tr - kept, min=0.0) / torch.clamp(tr, min=1e-30)
    aux = aux.clone()
    aux[..., AUX_TRUNC] = frac.to(aux.dtype)
    return aux


def rsvd_overwrite(spec: KFactorSpec, st: KFactorState,
                   omega: Optional[Tensor] = None,
                   generator: Optional[torch.Generator] = None
                   ) -> KFactorState:
    """RSVD of the dense EA factor → overwrite the low-rank state."""
    U, D = rsvd.rsvd_psd(st.M, spec.r, spec.r_o, spec.n_pwr_iter,
                         pad_to=spec.width, omega=omega, generator=generator)
    return KFactorState(U=U, D=D, M=st.M,
                        aux=_trunc_mass_aux(st.aux, st.M, D))


def evd_overwrite(spec: KFactorSpec, st: KFactorState) -> KFactorState:
    """Dense EVD of the EA factor (K-FAC baseline inverse update)."""
    U, D = rsvd.exact_evd(st.M, r=spec.width, pad_to=spec.width)
    return KFactorState(U=U, D=D, M=st.M,
                        aux=_trunc_mass_aux(st.aux, st.M, D))


def draw_correction_idx(spec: KFactorSpec, batch: int,
                        generator: Optional[torch.Generator] = None,
                        device=None) -> Tensor:
    """Alg 6's column choice: n_crc of the first r columns, uniformly
    without replacement, per slot → (batch, n_crc) int64."""
    keys = torch.rand((batch, spec.r), generator=generator, device=device)
    return torch.argsort(keys, dim=-1)[:, :spec.n_crc]


def light_correction(spec: KFactorSpec, st: KFactorState,
                     idx: Optional[Tensor] = None,
                     generator: Optional[torch.Generator] = None
                     ) -> KFactorState:
    """Alg 6: re-solve the eigenproblem of M in a random n_crc-column
    subspace of U and patch those columns/eigenvalues in place.
    st: one flat batch axis (B, …); idx: (B, n_crc) column indices."""
    batch, d, _ = st.U.shape
    if idx is None:
        idx = draw_correction_idx(spec, batch, generator, st.U.device)
    idx = idx.to(st.U.device, torch.int64)
    cols = idx[:, None, :].expand(batch, d, idx.shape[-1])
    Usub = torch.gather(st.U, -1, cols)                     # (B, d, n_crc)
    Ms = Usub.transpose(-1, -2) @ (st.M @ Usub)
    Ms = 0.5 * (Ms + Ms.transpose(-1, -2))
    vals, vecs = eigh(Ms)
    vals, vecs = vals.flip(-1), vecs.flip(-1)
    U_new = st.U.scatter(-1, cols, Usub @ vecs)
    D_new = st.D.scatter(-1, idx, vals)
    return KFactorState(U=U_new, D=D_new, M=st.M, aux=st.aux)


_NS_PWR_ITERS = 12   # power-iteration steps for the λ_max(M) prescale
_NS_RES_MAX = 0.5    # Frobenius residual past which a slot falls back


def _ns_sym(x: Tensor) -> Tensor:
    return 0.5 * (x + x.transpose(-1, -2))


def _ns_lmax(M: Tensor) -> Tensor:
    """λ_max estimate of a symmetric psd M (*stack, d, d) → (*stack,) by
    power iteration (Rayleigh quotient) from the deterministic all-ones
    start; an M whose top eigenvector is orthogonal to it is
    underestimated, which the residual fallback of ``ns_overwrite``
    catches."""
    d = M.shape[-1]
    v = torch.full(M.shape[:-1] + (1,), 1.0 / (d ** 0.5), dtype=M.dtype,
                   device=M.device)
    for _ in range(_NS_PWR_ITERS):
        w = M @ v
        nrm = torch.sqrt(torch.sum(w * w, dim=(-2, -1), keepdim=True))
        v = w / torch.clamp(nrm, min=1e-30)
    return torch.sum(v * (M @ v), dim=(-2, -1))


def _ns_resnorm(R: Tensor, iters: int = 8) -> Tensor:
    """Spectral-norm estimate ‖R‖₂ of (*stack, d, d) → (*stack,) by power
    iteration on RᵀR."""
    d = R.shape[-1]
    Rt = R.transpose(-1, -2)
    v = torch.full(R.shape[:-1] + (1,), 1.0 / (d ** 0.5), dtype=R.dtype,
                   device=R.device)
    for _ in range(iters):
        w = Rt @ (R @ v)
        nrm = torch.sqrt(torch.sum(w * w, dim=(-2, -1), keepdim=True))
        v = w / torch.clamp(nrm, min=1e-30)
    w = R @ v
    return torch.sqrt(torch.sum(w * w, dim=(-2, -1)))


def ns_overwrite(spec: KFactorSpec, st: KFactorState) -> KFactorState:
    """Newton–Schulz heavy refresh (Mode.NS): refine X ≈ M̂⁻¹ = (M + λ̂I)⁻¹
    with ``spec.ns_iters`` Hotelling steps X ← X(2I − M̂X) through
    ``ops.ns_step`` (the ``ns_inverse`` kernel on the card).

    λ̂ = ns_phi · λ_max(M) by power iteration; warm start from the stale
    inverse in U when its residual ‖I − M̂U‖₂ is below ``ns_guard``, else
    the cold start α·I with α = 2/(λ_max + 2λ̂).  A slot whose final
    Frobenius residual ‖I − M̂X‖_F is not below ``_NS_RES_MAX`` (NaN
    included) takes the dense LU inverse of M̂ instead — the reference's
    algorithm; the host check runs only on heavy steps, and the other
    slots keep their NS result bit for bit.  Stacked-native.  U becomes
    the damped inverse, D all-zero, aux[..., AUX_LAM] = λ̂ and
    aux[..., AUX_RES] = the final residual."""
    from repro_torch.kernels import ops as kops

    M = _ns_sym(st.M)
    lmax = torch.clamp(_ns_lmax(M), min=1e-12)
    lam = spec.ns_phi * lmax                               # (*stack,)
    eye = torch.eye(spec.d, dtype=M.dtype, device=M.device)
    Mhat = M + lam[..., None, None] * eye
    alpha = 2.0 / (lmax + 2.0 * lam)
    X_cold = alpha[..., None, None] * eye
    X_warm = _ns_sym(st.U)
    r_warm = _ns_resnorm(eye - Mhat @ X_warm)
    use_warm = r_warm < spec.ns_guard                      # NaN → False
    X = torch.where(use_warm[..., None, None], X_warm, X_cold)
    for _ in range(spec.ns_iters):
        X = kops.ns_step(Mhat, X)
    R = eye - Mhat @ X
    res = torch.sqrt(torch.sum(R * R, dim=(-2, -1)))
    bad = ~(res < _NS_RES_MAX)                             # NaN/Inf → True
    if bool(bad.any()):                  # LU inverse of the bad slots only
        X[bad] = torch.linalg.inv_ex(Mhat[bad])[0]
    aux = st.aux.clone()
    aux[..., AUX_LAM] = lam.to(aux.dtype)
    aux[..., AUX_RES] = res.to(aux.dtype)
    return KFactorState(U=X.to(st.U.dtype), D=torch.zeros_like(st.D),
                        M=st.M, aux=aux)


# ---------------------------------------------------------------------------
# the per-bucket program
# ---------------------------------------------------------------------------

def has_heavy_op(spec: KFactorSpec) -> bool:
    """True iff the mode has a periodic heavy op (pure BRAND has none)."""
    return spec.mode in (Mode.EVD, Mode.RSVD, Mode.BRAND_RSVD,
                         Mode.BRAND_CORR, Mode.NS)


def needs_draws(spec: KFactorSpec) -> bool:
    """True iff the mode's heavy op consumes random draws."""
    return spec.mode in (Mode.RSVD, Mode.BRAND_RSVD, Mode.BRAND_CORR)


def draw_heavy(spec: KFactorSpec, batch: int,
               generator: Optional[torch.Generator], device=None) -> Tensor:
    """One bucket's draws for its heavy op: the RSVD test matrices
    (batch, d, r+r_o) or the correction columns (batch, n_crc)."""
    if spec.mode is Mode.BRAND_CORR:
        return draw_correction_idx(spec, batch, generator, device)
    k = min(spec.r + spec.r_o, spec.d)
    return torch.randn((batch, spec.d, k), generator=generator,
                       device=device)


def has_work(spec: KFactorSpec, do_stats: bool, do_light: bool,
             do_heavy: bool) -> bool:
    """True iff this step's flags actually touch the factor state."""
    if do_stats and spec.needs_m:
        return True
    if (do_light or do_heavy) and spec.mode in _HAS_BRAND:
        return True
    if do_heavy and has_heavy_op(spec):
        return True
    return False


def stats_step(spec: KFactorSpec, st: KFactorState, X: Tensor, first: bool
               ) -> KFactorState:
    """Absorb one incoming stats factor X into the EA (dense M if held) —
    always through ``ops.ea_syrk``, as the reference does."""
    if spec.needs_m:
        M = ea_update_m_kernel(st.M, X, spec.rho, first)
        return KFactorState(U=st.U, D=st.D, M=M, aux=st.aux)
    return st


def inverse_rep_step(spec: KFactorSpec, st: KFactorState, X: Tensor,
                     first: bool, heavy: bool, use_kernel: bool = False,
                     draws: Optional[Tensor] = None,
                     generator: Optional[torch.Generator] = None
                     ) -> KFactorState:
    """Scheduled inverse-representation update (flat batch axis B): the
    Brand update for the Brand modes, then, if ``heavy``, the mode's
    heavy op (EVD / RSVD overwrite / correction / NS refinement)."""
    if spec.mode in _HAS_BRAND:
        st = brand_step(spec, st, X, first, use_kernel)
    if heavy and has_heavy_op(spec):
        st = heavy_overwrite_batched(spec, st, draws, generator)
    return st


def heavy_overwrite_batched(spec: KFactorSpec, st: KFactorState,
                            draws: Optional[Tensor] = None,
                            generator: Optional[torch.Generator] = None
                            ) -> KFactorState:
    """Unconditional heavy op over one flat batch axis (B, …): dense EVD /
    RSVD overwrite / Alg-6 correction.  ``draws`` are the op's random
    inputs for these B slots (see ``draw_heavy``)."""
    if spec.mode is Mode.EVD:
        return evd_overwrite(spec, st)
    if spec.mode is Mode.NS:
        return ns_overwrite(spec, st)
    if spec.mode in (Mode.RSVD, Mode.BRAND_RSVD):
        return rsvd_overwrite(spec, st, omega=draws, generator=generator)
    if spec.mode is Mode.BRAND_CORR:
        return light_correction(spec, st, idx=draws, generator=generator)
    return st


def bucket_factor_step(spec: KFactorSpec, st: KFactorState, X: Tensor,
                       first: bool, stats: bool, light: bool,
                       heavy_ranges: Sequence[Tuple[int, int]],
                       use_kernel: bool = False,
                       draws: Optional[Tensor] = None,
                       generator: Optional[torch.Generator] = None
                       ) -> KFactorState:
    """One scheduled step for a whole shape-class bucket (flat batch axis
    B): stats absorb, the Brand light update (bucket-wide whenever the
    step is light OR any heavy fires — the reference's coupling), then the
    heavy overwrite of each slot range in ``heavy_ranges``.  ``draws``
    holds the heavy op's random inputs for all B slots; each range takes
    its slice.  Each phase is a profiler span (``stats``,
    ``light_brand``, ``heavy_{lo}_{hi}``)."""
    if stats:
        with obs_trace.span("stats"):
            st = stats_step(spec, st, X, first)
    heavy_ranges = tuple(heavy_ranges)
    if (light or heavy_ranges) and spec.mode in _HAS_BRAND:
        with obs_trace.span("light_brand"):
            st = brand_step(spec, st, X, first, use_kernel)
    for lo, hi in heavy_ranges:
        with obs_trace.span(f"heavy_{lo}_{hi}"):
            sub = st.map(lambda x: x[lo:hi])
            sub = heavy_overwrite_batched(
                spec, sub, None if draws is None else draws[lo:hi],
                generator)
            if (lo, hi) == (0, st.U.shape[0]):
                st = sub
                continue
            st = KFactorState(U=_put(st.U, lo, hi, sub.U),
                              D=_put(st.D, lo, hi, sub.D),
                              M=_put(st.M, lo, hi, sub.M),
                              aux=_put(st.aux, lo, hi, sub.aux))
    return st


def _put(full: Tensor, lo: int, hi: int, part) -> Tensor:
    """A copy of ``full`` with slots [lo, hi) set to ``part``."""
    full = full.clone()
    full[lo:hi] = part
    return full


# ---------------------------------------------------------------------------
# the async heavy pipeline: snapshot at launch, swap in at land
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class InflightState:
    """Double buffer for one bucket's async heavy pipeline (all leaves
    slot-major, leading axis = the bucket's B slots).

    U/D/M: (B, d, w) / (B, w) / (B, d, d) snapshots of the live state
    (post-stats, post-Brand: what the inline heavy op would read).
    draws: the launch step's random inputs of the heavy op — (B, d, k)
    RSVD test matrices, (B, n_crc) correction columns, or (B, 0) for
    modes that draw nothing.
    panels: (B, n_replay, d, n_stat) ring of the last light panels,
    oldest first.
    live: (B,) bool — set at launch, consumed at land; a landing swaps
    only live slots, so a dropped or never-fired launch makes it a
    per-slot no-op."""
    U: Tensor
    D: Tensor
    M: Tensor
    draws: Tensor
    panels: Tensor
    live: Tensor

    def map(self, fn) -> "InflightState":
        return InflightState(U=fn(self.U), D=fn(self.D), M=fn(self.M),
                             draws=fn(self.draws), panels=fn(self.panels),
                             live=fn(self.live))


def make_inflight(spec: KFactorSpec, total: int, n_replay: int,
                  dtype=torch.float32, device=None) -> InflightState:
    """Zero-initialized in-flight buffer for a bucket of ``total`` slots."""
    z = lambda *s, dt=dtype: torch.zeros(s, dtype=dt, device=device)
    if spec.mode is Mode.BRAND_CORR:
        draws = z(total, spec.n_crc, dt=torch.int64)
    elif needs_draws(spec):
        draws = z(total, spec.d, min(spec.r + spec.r_o, spec.d))
    else:
        draws = z(total, 0)
    m_shape = (spec.d, spec.d) if spec.needs_m else (1, 1)
    return InflightState(U=z(total, spec.d, spec.width),
                         D=z(total, spec.width), M=z(total, *m_shape),
                         draws=draws,
                         panels=z(total, n_replay, spec.d, spec.n_stat),
                         live=z(total, dt=torch.bool))


def record_panel(buf: InflightState, X: Tensor) -> InflightState:
    """Shift the light-panel ring left and append this step's panel."""
    if buf.panels.shape[1] == 0:
        return buf
    panels = torch.cat([buf.panels[:, 1:], X[:, None].to(buf.panels.dtype)],
                       dim=1)
    return dataclasses.replace(buf, panels=panels)


def launch_snapshot(buf: InflightState, st: KFactorState,
                    draws: Optional[Tensor], lo: int, hi: int
                    ) -> InflightState:
    """Snapshot the live state (and this step's draws) of slots [lo, hi)
    into the buffer — the operands of the future heavy op."""
    return InflightState(
        U=_put(buf.U, lo, hi, st.U[lo:hi]),
        D=_put(buf.D, lo, hi, st.D[lo:hi]),
        M=_put(buf.M, lo, hi, st.M[lo:hi]),
        draws=(buf.draws if draws is None
               else _put(buf.draws, lo, hi, draws[lo:hi])),
        panels=buf.panels,
        live=_put(buf.live, lo, hi, True))


def heavy_from_snapshot(spec: KFactorSpec, buf: InflightState,
                        lo: int, hi: int) -> Tuple[Tensor, Tensor, Tensor]:
    """The heavy overwrite of slots [lo, hi), computed from the snapshot
    alone (no draws are taken: they are in the buffer) → the landed
    (U, D, aux).  The snapshot's aux is zeros, as in the reference: no
    heavy op reads it."""
    snap = KFactorState(U=buf.U[lo:hi], D=buf.D[lo:hi], M=buf.M[lo:hi],
                        aux=torch.zeros((hi - lo, AUX_WIDTH),
                                        dtype=buf.D.dtype,
                                        device=buf.D.device))
    out = heavy_overwrite_batched(
        spec, snap, buf.draws[lo:hi] if needs_draws(spec) else None)
    return out.U, out.D, out.aux


def replay_panels(spec: KFactorSpec, U: Tensor, D: Tensor, panels: Tensor,
                  use_kernel: bool = False) -> Tuple[Tensor, Tensor]:
    """Replay the interim light panels (oldest first) onto a landed
    inverse rep, so it carries every Brand absorb the live state received
    while the heavy op was in flight."""
    for j in range(panels.shape[1]):
        U, D = brand.ea_brand_step(U, D, panels[:, j], spec.rho, spec.r,
                                   use_kernel=use_kernel)
        if U.shape[-1] > spec.width:
            U, D = U[..., :, :spec.width], D[..., :spec.width]
    return U, D


def land_swap(spec: KFactorSpec, st: KFactorState, buf: InflightState,
              lo: int, hi: int, use_kernel: bool = False, landed=None
              ) -> Tuple[KFactorState, InflightState]:
    """Swap the landed inverse rep of slots [lo, hi) into the live state.
    ``landed`` is an optionally pre-computed (U, D, aux) from an
    overlapped dispatch; absent, the heavy op runs here from the snapshot
    (same function, same operands, same result).  Only live slots swap,
    and their flag is consumed."""
    U, D, aux = (heavy_from_snapshot(spec, buf, lo, hi) if landed is None
                 else landed)
    if spec.mode in _HAS_BRAND:
        U, D = replay_panels(spec, U, D, buf.panels[lo:hi], use_kernel)
    ok = buf.live[lo:hi]
    U = torch.where(ok[:, None, None], U, st.U[lo:hi])
    D = torch.where(ok[:, None], D, st.D[lo:hi])
    aux = torch.where(ok[:, None], aux, st.aux[lo:hi])
    st = KFactorState(U=_put(st.U, lo, hi, U), D=_put(st.D, lo, hi, D),
                      M=st.M, aux=_put(st.aux, lo, hi, aux))
    return st, dataclasses.replace(buf, live=_put(buf.live, lo, hi, False))


def bucket_factor_step_async(spec: KFactorSpec, st: KFactorState, X: Tensor,
                             first: bool, stats: bool, light: bool,
                             heavy_ranges, launch_ranges, land_ranges,
                             buf: Optional[InflightState],
                             use_kernel: bool = False,
                             draws: Optional[Tensor] = None, landed=None
                             ) -> Tuple[KFactorState, Optional[InflightState]]:
    """One scheduled step of the async pipeline for a whole bucket: the
    synchronous program (stats, Brand, any inline heavy such as the step-0
    warmup), then record the light panel, *launch* (snapshot the firing
    slots and their draws), *land* (swap in heavy-of-snapshot with the
    interim panels replayed).  With ``lag = 0`` the landing reads the
    snapshot just written, so the step is bit for bit the synchronous
    one.  ``draws`` are the bucket's draws of this step (all B slots),
    shared by the inline heavy ranges and the launch ranges; ``landed``
    optionally holds one pre-computed (U, D, aux) per land range."""
    st = bucket_factor_step(spec, st, X, first, stats, light, heavy_ranges,
                            use_kernel, draws=draws)
    if buf is None:
        return st, None
    if light:
        buf = record_panel(buf, X)
    for lo, hi in tuple(launch_ranges):
        with obs_trace.span(f"launch_{lo}_{hi}"):
            buf = launch_snapshot(buf, st, draws, lo, hi)
    for i, (lo, hi) in enumerate(tuple(land_ranges)):
        with obs_trace.span(f"land_{lo}_{hi}"):
            st, buf = land_swap(spec, st, buf, lo, hi, use_kernel,
                                landed=None if landed is None
                                else landed[i])
    return st, buf
