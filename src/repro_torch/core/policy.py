"""Per-layer K-factor method selection — the paper's §3.5 "mixture of
Randomized K-FACs and Brand New K-FACs".

Counterpart of ``src/repro/core/policy.py``; the rules and both variant
tables are the reference's:
  * the B-update only pays off when  d > r + n_stat  (wide layers);
  * the dense EA factor can only be *formed* when d ≤ max_dense_dim;
  * modes that require M therefore degrade to pure BRAND above the gate;
  * below the B-threshold use the variant's narrow mode, and tiny factors
    (d ≤ r + r_o) take exact EVD.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.kfactor import KFactorSpec, Mode

#: optimizer variant → preferred mode for (wide, narrow) factors
_VARIANT_MODES = {
    "kfac":   (Mode.EVD, Mode.EVD),
    "rkfac":  (Mode.RSVD, Mode.RSVD),
    "bkfac":  (Mode.BRAND, Mode.RSVD),
    "brkfac": (Mode.BRAND_RSVD, Mode.RSVD),
    "bkfacc": (Mode.BRAND_CORR, Mode.RSVD),
    "nskfac": (Mode.NS, Mode.NS),
}

VARIANTS = tuple(_VARIANT_MODES)

#: variant → the KfacConfig field holding its heavy period (None: pure
#: B-KFAC has no periodic heavy op)
_VARIANT_HEAVY_PERIOD = {
    "kfac":   "T_inv",
    "rkfac":  "T_inv",
    "bkfac":  None,
    "brkfac": "T_rsvd",
    "bkfacc": "T_corct",
    "nskfac": "T_inv",
}


def _check_variant(variant: str) -> None:
    if variant not in _VARIANT_MODES:
        raise ValueError(f"unknown K-FAC variant {variant!r}; "
                         f"one of {VARIANTS}")


def heavy_period_field(variant: str):
    """Name of the KfacConfig field holding the variant's heavy period
    (``None`` for pure B-KFAC, which has no heavy op)."""
    _check_variant(variant)
    return _VARIANT_HEAVY_PERIOD[variant]


def has_light(variant: str) -> bool:
    """True iff the variant runs the Brand light update (B-family)."""
    _check_variant(variant)
    wide_mode, _ = _VARIANT_MODES[variant]
    return wide_mode in (Mode.BRAND, Mode.BRAND_RSVD, Mode.BRAND_CORR)


@dataclasses.dataclass(frozen=True)
class PolicyConfig:
    variant: str = "bkfac"
    r: int = 256                 # truncation / target rank
    r_o: int = 10                # RSVD oversampling
    n_pwr_iter: int = 2
    rho: float = 0.95
    phi_crc: float = 0.5         # n_crc = phi_crc * r  (B-KFAC-C)
    max_dense_dim: int = 8192    # memory gate for forming the d×d factor
    ns_iters: int = 8            # NS-KFAC: Newton–Schulz steps per firing
    ns_phi: float = 0.1          # NS-KFAC: λ̂ = ns_phi·λ_max(M)
    ns_guard: float = 0.9        # NS-KFAC: warm-start residual guard


def select_mode(cfg: PolicyConfig, d: int, n_stat: int) -> Mode:
    """Pick the factor's update mode.  Boundary semantics (they decide
    bucket membership and the scheduler's units):

      * ``d > r + n_stat`` strictly → the B-update applies;
      * ``d > max_dense_dim`` strictly → M cannot be formed;
      * ``d ≤ r + r_o`` → EVD override, applied LAST (NS exempt).
    """
    _check_variant(cfg.variant)
    wide_mode, narrow_mode = _VARIANT_MODES[cfg.variant]
    r = min(cfg.r, d)
    b_applicable = d > r + n_stat
    mode = wide_mode if b_applicable else narrow_mode
    if d > cfg.max_dense_dim and mode in (Mode.EVD, Mode.RSVD,
                                          Mode.BRAND_RSVD, Mode.BRAND_CORR,
                                          Mode.NS):
        mode = Mode.BRAND
    if d <= r + cfg.r_o and mode is not Mode.NS:
        mode = Mode.EVD
    return mode


def make_factor_spec(cfg: PolicyConfig, d: int, n_stat: int) -> KFactorSpec:
    mode = select_mode(cfg, d, n_stat)
    r = min(cfg.r, d)
    n_crc = max(1, int(cfg.phi_crc * r)) if mode == Mode.BRAND_CORR else 0
    return KFactorSpec(d=d, r=r, n_stat=n_stat, mode=mode, rho=cfg.rho,
                       r_o=cfg.r_o, n_pwr_iter=cfg.n_pwr_iter, n_crc=n_crc,
                       ns_iters=cfg.ns_iters, ns_phi=cfg.ns_phi,
                       ns_guard=cfg.ns_guard)
