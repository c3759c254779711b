"""The optimizer config the serving stack fine-tunes with.

Counterpart of ``src/repro/launch/steps.py``, its pure-config part:
:func:`default_kfac_config` (reference ``:40-51``).  The step builders
with mesh shardings (``build_train_step`` and the rest) are not ported
yet.
"""
from __future__ import annotations

from repro_torch.configs.base import ArchConfig
from repro_torch.core import kfac as kfac_lib
from repro_torch.core import policy as policy_lib
from repro_torch.optim import base as optbase


def default_kfac_config(arch: ArchConfig, variant: str = "bkfac",
                        use_kernels: bool = False) -> kfac_lib.KfacConfig:
    """The reference's LM defaults: r 256, max_dense_dim 8192, lr 0.3,
    damping 0.1, weight decay 7e-4, clip 0.07, the pretraining cadence
    (T_updt = T_brand = 25, T_inv = T_rsvd = 250, T_corct = 500) and an
    AdamW fallback at 1e-3.  ``arch`` is unused, as in the reference."""
    pol = policy_lib.PolicyConfig(variant=variant, r=256,
                                  max_dense_dim=8192)
    return kfac_lib.KfacConfig(
        policy=pol,
        lr=optbase.constant(0.3),
        damping_phi=optbase.constant(0.1),
        weight_decay=7e-4, clip=0.07,
        use_kernels=use_kernels,
        T_updt=25, T_inv=250, T_brand=25, T_rsvd=250, T_corct=500,
        fallback_lr=optbase.constant(1e-3))
