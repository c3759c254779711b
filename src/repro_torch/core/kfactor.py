"""EA K-factor state and its update modes — the heart of the paper.

Counterpart of ``src/repro/core/kfactor.py``, synchronous subset.  A
K-factor is the exponential average  M_k = ρ M_{k-1} + (1-ρ) X_k X_kᵀ
(paper eq. 5/8); each optimizer variant is a choice of how the *inverse
representation* (U, D) of M is maintained:

  mode        holds M?   update of (U, D)                         paper
  EVD         yes        dense eigh of M every T_inv              K-FAC
  RSVD        yes        rsvd_psd(M) every T_inv                  R-KFAC
  BRAND       no         ea_brand_step every T_brand              B-KFAC
  BRAND_RSVD  yes        Brand + RSVD overwrite every T_rsvd      B-R-KFAC
  BRAND_CORR  yes        Brand + light correction every T_corct   B-KFAC-C
  NS          yes        Newton–Schulz refinement (nskfac slice — not
                         ported yet)

Every operation is stacked-native over leading batch axes.  The random
inputs of the heavy ops — the RSVD test matrix ``omega`` and the Alg-6
column choice ``idx`` — are drawn from a ``torch.Generator`` or injected
by the caller (``heavy_overwrite_batched(draws=...)``).  The async
pipeline of the reference (``InflightState`` …) is a later slice.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.core import brand, rsvd
from repro_torch.kernels.ref import eigh

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

_NS_TODO = ("Mode.NS (nskfac) is not ported yet: see ROADMAP.md, the "
            "ns_inverse / nskfac slice")


@dataclasses.dataclass
class KFactorState:
    """Inverse representation of one EA K-factor (or a stack of them).

    U: (…, d, width) column-orthonormal; D: (…, width) descending;
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
        raise NotImplementedError(_NS_TODO)
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
    its slice."""
    if spec.mode is Mode.NS:
        raise NotImplementedError(_NS_TODO)
    if stats:
        st = stats_step(spec, st, X, first)
    heavy_ranges = tuple(heavy_ranges)
    if (light or heavy_ranges) and spec.mode in _HAS_BRAND:
        st = brand_step(spec, st, X, first, use_kernel)
    for lo, hi in heavy_ranges:
        sub = st.map(lambda x: x[lo:hi])
        sub = heavy_overwrite_batched(
            spec, sub, None if draws is None else draws[lo:hi], generator)
        if (lo, hi) == (0, st.U.shape[0]):
            st = sub
            continue

        def put(full, part):
            full = full.clone()
            full[lo:hi] = part
            return full
        st = KFactorState(U=put(st.U, sub.U), D=put(st.D, sub.D),
                          M=put(st.M, sub.M), aux=put(st.aux, sub.aux))
    return st
