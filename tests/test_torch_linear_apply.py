"""A 6-step B-KFAC loss trajectory with fc0 and fc1 as Alg-8 linear-apply
taps (``TapInfo.linear_apply``, set with ``dataclasses.replace`` on the
taps both packages' ``make_vgg`` return), the port's ``run_kfac_training``
against the reference's, eagerly (``jit=False``), on the small VGG of
``test_torch_vgg.py`` and with its trajectory settings: use_kernels=True,
lr 0.03, clip 0.1, fallback lr 1e-3, the spectrum continuation off, the
reference's draws injected.  fc0's A side (d = 4096) and G side (d = 64)
and fc1's A side (d = 64) are Brand factors; fc1's G side (d = 10) is EVD,
so ``lowrank_apply`` runs on real Brand factors on every step.  A file of
its own, so that the test runner spreads it.
"""
import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from test_torch_vgg import _trajectories  # noqa: E402


def test_linear_apply_trajectory_matches_reference():
    jlosses, tlosses = _trajectories(6, continuation=False,
                                     linear=("fc0", "fc1"))
    assert np.all(np.isfinite(tlosses))
    # fp32 rounding over 6 steps in two libraries, as the B-KFAC
    # trajectory of test_torch_vgg.py
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-4)
