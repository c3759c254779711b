"""The async heavy pipeline's whole slice held against the JAX package:
B-R-KFAC with ``async_heavy`` on a one-stage VGG, launches and landings
through the port's ``run_kfac_training(overlap=True)`` (the heavy op in
the runner's worker thread) against the reference's
``run_kfac_training``, from the same weights, batches and draws.  Its
parts are ``test_torch_async.py``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.train import loop as jloop  # noqa: E402
from repro_torch.core import kfac as tkfac  # noqa: E402
from repro_torch.optim import base as tbase  # noqa: E402
from repro_torch.train import loop as tloop  # noqa: E402
from test_torch_async import reference_draws_async  # noqa: E402
from test_torch_vgg import (BATCH, CPU, _np_tree, configs,  # noqa: E402
                            jax_batches, params_from_jax, to_torch_batch)


#: the whole-slice model: one stage of 8 channels, so the trajectory keeps
#: every kind of bucket of the small VGG (EVD d = 8, 10; RSVD d = 27;
#: BRAND_RSVD d = 64, 72, the async buckets with a replayed panel; BRAND
#: d = 4096) at a third of its reference cost
TINY = dict(stages=(8,), fc_hidden=64, n_stat=32)


def test_brkfac_async_trajectory_matches_reference():
    """6 steps of B-R-KFAC on a one-stage VGG with async_heavy, T_updt =
    T_brand = 1, T_rsvd = 2, heavy_lag = 1 (launches at steps 2 and 4,
    landings at 3 and 5, one replayed panel each), use_kernels=True: the
    port's run_kfac_training(overlap=True) against the reference's, with
    the reference's draws injected on every heavy and launch step, at
    test_torch_vgg.py's trajectory tolerance (rtol 1e-4; QUIET step size,
    continuation off).  The reference runs jitted: eagerly this model
    takes 37 s for 4 steps on an 8-core CPU host against 15 s for 6
    jitted (the jitted backward's miss of a float64 witness, in
    test_torch_vgg.py, is on the two-stage VGG's batch 0; here the port
    is within 1.1e-7 of the jitted loop)."""
    from repro.core import kfac as jkfac
    from repro.models.cnn import VggConfig as JVggConfig
    from repro.models.cnn import make_vgg as jmake_vgg
    from repro.optim import base as jbase
    from repro_torch.models.cnn import VggConfig, make_vgg
    from test_torch_vgg import QUIET
    periods = dict(T_updt=1, T_brand=1, T_inv=2, T_rsvd=2, T_corct=2,
                   async_heavy=True, heavy_lag=1, spectrum_continuation=False)
    jc, tc = configs("brkfac", True, **periods)
    jc = dataclasses.replace(jc, lr=jbase.constant(QUIET["lr"]),
                             clip=QUIET["clip"],
                             fallback_lr=jbase.constant(QUIET["fallback_lr"]))
    tc = dataclasses.replace(tc, lr=tbase.constant(QUIET["lr"]),
                             clip=QUIET["clip"],
                             fallback_lr=tbase.constant(QUIET["fallback_lr"]))
    init, jloss, _, jtaps = jmake_vgg(JVggConfig(**TINY))
    jparams = init(jax.random.PRNGKey(0))
    model, ttaps = make_vgg(VggConfig(**TINY), device=CPU)
    model.load_params(params_from_jax(_np_tree(jparams), device=CPU))
    jopt, topt = jkfac.Kfac(jc, jtaps), tkfac.Kfac(tc, ttaps, device=CPU)
    assert topt._async_buckets == jopt._async_buckets == {
        0: 0, 1: 0, 2: 0, 3: 1, 4: 1}
    n = 6
    kinds = [topt.scheduler().work(k).label for k in range(n)]
    assert kinds == ["heavy", "light", "launch", "heavy", "launch", "heavy"]
    jb = jax_batches(n)
    sched, rng, draws = jopt.scheduler(), jax.random.PRNGKey(0), {}
    for k in range(n):
        rng, sub = jax.random.split(rng)
        draws[k] = reference_draws_async(jopt, sub, sched.work(k))
    _, jlosses = jloop.run_kfac_training(jloss, jopt, jparams, jb,
                                         n_tokens=BATCH, seed=0)
    runner = tloop.AsyncInverseRunner.for_opt(topt)
    _, tlosses = tloop.run_kfac_training(
        model.loss, topt, model.params(), [to_torch_batch(b) for b in jb],
        n_tokens=BATCH, seed=0, device=CPU, draws=draws.get, overlap=runner)
    assert runner.health["landed"] == runner.health["launched"] == 2 * len(
        topt._async_buckets)
    assert runner.health["missed"] == 0
    assert np.all(np.isfinite(tlosses))
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-4)
