"""A 6-step NS-KFAC loss trajectory: the port's ``run_kfac_training``
against the reference's, eagerly (``jit=False``), from the same weights
and batches, with the trajectory settings of ``test_torch_vgg.py``
(use_kernels=True, lr 0.03, clip 0.1, fallback lr 1e-3, the spectrum
continuation off, batch 16).

The VGG is the example's small preset (stages 16-32-64, FC 512, n_stat
64, r 96) at max_dense_dim 512: every factor with d ≤ 512 is NS, and the
memory gate makes the A sides of conv2_1 (d = 576) and fc0 (d = 8192)
BRAND, so their precond buckets are mixed and ``lowrank_apply`` runs.
Under nskfac those BRAND factors are never updated (the reference's
behaviour, which the port mirrors: ROADMAP queue 3), and the test checks
that they stay zero in both.  T_inv = 5, so step 0 refreshes from the
cold start and step 5 from the warm one.  A file of its own, so that the
test runner spreads it.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.core import kfac as jkfac  # noqa: E402
from repro.core import policy as jpolicy  # noqa: E402
from repro.data.synthetic import ImageStream as JImageStream  # noqa: E402
from repro.models.cnn import VggConfig as JVggConfig, make_vgg as jmake_vgg  # noqa: E402,E501
from repro.optim import base as jbase  # noqa: E402
from repro.train import loop as jloop  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import kfac as tkfac  # noqa: E402
from repro_torch.core import policy as tpolicy  # noqa: E402
from repro_torch.models.cnn import VggConfig, make_vgg  # noqa: E402
from repro_torch.optim import base as tbase  # noqa: E402
from repro_torch.train import loop as tloop  # noqa: E402

from test_torch_vgg import BATCH, CPU, QUIET, to_torch_batch  # noqa: E402

PRESET = dict(stages=(16, 32, 64), fc_hidden=512, n_stat=64)
STEPS = 6


def _kfac_kw(base):
    return dict(lr=base.constant(QUIET["lr"]), clip=QUIET["clip"],
                fallback_lr=base.constant(QUIET["fallback_lr"]),
                damping_phi=base.constant(0.1), weight_decay=7e-4,
                spectrum_continuation=False, use_kernels=True,
                T_updt=2, T_brand=2, T_inv=5, T_rsvd=5, T_corct=5)


def test_nskfac_trajectory_matches_reference():
    init, jloss, _, jtaps = jmake_vgg(JVggConfig(**PRESET))
    jparams = init(jax.random.PRNGKey(0))
    model, ttaps = make_vgg(VggConfig(**PRESET), device=CPU)
    model.load_params(params_from_jax(jax.tree_util.tree_map(
        np.asarray, jparams), device=CPU))
    jopt = jkfac.Kfac(jkfac.KfacConfig(
        policy=jpolicy.PolicyConfig(variant="nskfac", r=96,
                                    max_dense_dim=512), **_kfac_kw(jbase)),
        jtaps)
    topt = tkfac.Kfac(tkfac.KfacConfig(
        policy=tpolicy.PolicyConfig(variant="nskfac", r=96,
                                    max_dense_dim=512), **_kfac_kw(tbase)),
        ttaps, device=CPU)
    gated = sorted(n for n in ttaps
                   if topt.specs[n]["A"].mode.value == "brand")
    assert gated == ["conv2_1", "fc0"]
    stream = JImageStream(batch=BATCH, seed=0)
    jb = [stream.batch_at(i) for i in range(STEPS)]
    jstate, jlosses = jloop.run_kfac_training(jloss, jopt, jparams, jb,
                                              n_tokens=BATCH, seed=0,
                                              jit=False)
    tstate, tlosses = tloop.run_kfac_training(
        model.loss, topt, model.params(), [to_torch_batch(b) for b in jb],
        n_tokens=BATCH, seed=0, device=CPU)
    assert np.all(np.isfinite(tlosses))
    # fp32 rounding over 6 steps in two libraries, as the B-KFAC
    # trajectory of test_torch_vgg.py
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-4)
    for name in gated:
        for st in (jstate.opt.factors[name].A, tstate.opt.factors[name].A):
            assert float(np.abs(np.asarray(st.U)).max()) == 0.0
            assert float(np.asarray(st.D).max()) == 0.0
