"""One ``Kfac.update`` sequence per variant (kfac, rkfac, bkfac, brkfac,
bkfacc, nskfac) on the plain route (``use_kernels=False``), held against
the JAX package's ``Kfac.update`` on identical gradients, activations and
probe gradients (the reference's, as numpy), with the reference's random
draws injected; the same for B-KFAC with fc0 and fc1 as Alg-8
linear-apply taps; and the port's per-tap path (``bucketed=False``)
against its bucketed path.  Updates are compared per parameter, factor
states as U·diag(D)·Uᵀ (NS: U itself, the dense inverse) and M.  The
small VGG and the helpers come from ``test_torch_vgg.py``.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from test_torch_vgg import (BATCH, CPU, PAPER_VARIANTS, _close_rel,  # noqa: E402,E501
                            _jax_grads, _np_tree, _tensors, configs,
                            jax_batches, jax_model, jkfac, params_from_jax,
                            recon, reference_draws, tkfac, torch_model)
from repro_torch.core import kfactor as tkf  # noqa: E402


@pytest.fixture(scope="module")
def reference_grads():
    """The reference's gradients on one batch, computed once per module.
    Both packages are handed these same arrays, so the reference's jitted
    backward serves (on this batch it differs from float64, which its
    eager backward and the port match — see
    test_torch_vgg.test_grads_match_float64_witness — but here it is only
    an input)."""
    jparams, jloss, jtaps = jax_model()
    _, ttaps = torch_model(jparams)
    _, acts, gp, gprobe = jax.jit(
        lambda p, b: _jax_grads(p, jloss, jtaps, b))(jparams,
                                                     jax_batches(1)[0])
    return jparams, jloss, jtaps, ttaps, acts, gp, gprobe


ALL_VARIANTS = PAPER_VARIANTS + ("nskfac",)
LINEAR = ("fc0", "fc1")


@pytest.mark.parametrize("variant", ALL_VARIANTS)
def test_kfac_update_matches_reference(variant, reference_grads):
    """The plain route (``use_kernels=False``); the kernel route is
    test_torch_kfac_kernels.py.  Under nskfac (max_dense_dim 1024) fc0's
    4096-wide A side is a gated BRAND factor beside an NS G side, so its
    precond bucket is mixed."""
    check_update_sequence(variant, False, reference_grads)


def test_kfac_update_linear_apply_matches_reference(reference_grads):
    """B-KFAC with fc0 and fc1 as Alg-8 linear-apply taps, bucketed."""
    check_update_sequence("bkfac", False, reference_grads, linear=LINEAR)


def _linear(taps, names):
    return {n: dataclasses.replace(t, linear_apply=n in names)
            for n, t in taps.items()}


def check_update_sequence(variant, use_kernels, reference_grads,
                          linear=()):
    """Two updates from the same gradients, every period 1: step 0 (stats,
    Brand init and every heavy op — the warmup), step 1 (stats, the Brand
    update and the heavy op on a non-initial state: the NS warm start).
    Both steps share one work mask, so the reference compiles its update
    once.  ``linear`` names the taps set to Alg-8 linear apply."""
    jc, tc = configs(variant, use_kernels, T_updt=1, T_brand=1, T_inv=1,
                     T_rsvd=1, T_corct=1)
    jparams, jloss, jtaps, ttaps, acts, gp, gprobe = reference_grads
    jtaps, ttaps = _linear(jtaps, linear), _linear(ttaps, linear)
    jopt, topt = jkfac.Kfac(jc, jtaps), tkfac.Kfac(tc, ttaps, device=CPU)
    t_params = params_from_jax(_np_tree(jparams), device=CPU)
    t_grads = params_from_jax(_np_tree(gp), device=CPU)
    t_acts, t_gprobe = _tensors(acts), _tensors(gprobe)
    jst, tst = jopt.init(jparams), topt.init(t_params)
    jupd = jax.jit(jopt.update, static_argnames=("work",))
    jsched, tsched = jopt.scheduler(), topt.scheduler()
    for k in range(2):
        jw, tw = jsched.work(k), tsched.work(k)
        rng = jax.random.PRNGKey(100 + k)
        ju, jst = jupd(gp, jst, jparams, acts=acts, probe_grads=gprobe,
                       n_tokens=BATCH, rng=rng, work=jw)
        tu, tst = topt.update(t_grads, tst, t_params, acts=t_acts,
                              probe_grads=t_gprobe, n_tokens=BATCH,
                              rng=None, work=tw,
                              draws=reference_draws(jopt, rng, jw))
        # tolerance: eighs, SVDs and QRs from two LAPACKs over fp32 inputs,
        # two steps deep: 2e-3 of each tensor's own scale (the
        # reference's fp32 parity tolerance)
        want = params_from_jax(_np_tree(ju), device=CPU)
        for key in want:
            _close_rel(tu[key], want[key], 2e-3, f"step {k} update[{key}]")
        for name in jtaps:
            for side in ("A", "G"):
                js = getattr(jst.factors[name], side)
                ts = getattr(tst.factors[name], side)
                _close_rel(recon(ts), recon(js), 2e-3,
                           f"step {k} {name}.{side} U·D·Uᵀ")
                if topt.specs[name][side].mode is tkf.Mode.NS:
                    _close_rel(ts.U, js.U, 2e-3, f"step {k} {name}.{side} U")
                _close_rel(ts.M, js.M, 2e-3, f"step {k} {name}.{side} M")
        assert (tst.step, tst.n_stats, tst.phase) == (
            int(jst.step), int(jst.n_stats), int(jst.phase))




@pytest.mark.parametrize("variant,linear", [("bkfac", LINEAR),
                                            ("rkfac", ()), ("nskfac", ())])
def test_per_tap_path_matches_bucketed(variant, linear, reference_grads):
    """The port's per-tap path (``bucketed=False``) against its bucketed
    path, two updates from the same inputs and the same injected draws
    (the per-tap path takes its slot range of its bucket's draws) — the
    reference's own contract (tests/test_bucketing.py:183, atol 1e-5,
    rtol 1e-4)."""
    _, tc = configs(variant, False, T_updt=1, T_brand=1, T_inv=1,
                    T_rsvd=1, T_corct=1)
    jparams, jloss, jtaps, ttaps, acts, gp, gprobe = reference_grads
    jc, _ = configs(variant, False, T_updt=1, T_brand=1, T_inv=1,
                    T_rsvd=1, T_corct=1)
    jopt = jkfac.Kfac(jc, _linear(jtaps, linear))
    ttaps = _linear(ttaps, linear)
    t_params = params_from_jax(_np_tree(jparams), device=CPU)
    t_grads = params_from_jax(_np_tree(gp), device=CPU)
    t_acts, t_gprobe = _tensors(acts), _tensors(gprobe)
    outs = {}
    for bucketed in (True, False):
        opt = tkfac.Kfac(dataclasses.replace(tc, bucketed=bucketed), ttaps,
                         device=CPU)
        st, sched, outs[bucketed] = opt.init(t_params), opt.scheduler(), []
        for k in range(2):
            upd, st = opt.update(
                t_grads, st, t_params, acts=t_acts, probe_grads=t_gprobe,
                n_tokens=BATCH, rng=None, work=sched.work(k),
                draws=reference_draws(jopt, jax.random.PRNGKey(100 + k),
                                      jopt.scheduler().work(k)))
            outs[bucketed].append(upd)
    for k, (ub, ut) in enumerate(zip(outs[True], outs[False])):
        for key in ub:
            assert torch.isfinite(ut[key]).all()
            torch.testing.assert_close(ut[key], ub[key], atol=1e-5,
                                       rtol=1e-4, msg=f"step {k} {key}")
