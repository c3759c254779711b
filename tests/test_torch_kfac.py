"""One ``Kfac.update`` sequence per paper variant (kfac, rkfac, bkfac,
brkfac, bkfacc) on the plain route (``use_kernels=False``), held against the JAX package's
``Kfac.update`` on identical gradients, activations and probe gradients
(the reference's, as numpy), with the reference's random draws injected.
Updates are compared per parameter, factor states as U·diag(D)·Uᵀ and M.
The small VGG and the helpers come from ``test_torch_vgg.py``.
"""
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from test_torch_vgg import (BATCH, CPU, PAPER_VARIANTS, _close_rel,  # noqa: E402,E501
                            _jax_grads, _np_tree, _tensors, configs,
                            jax_batches, jax_model, jkfac, params_from_jax,
                            recon, reference_draws, tkfac, torch_model)


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


@pytest.mark.parametrize("variant", PAPER_VARIANTS)
def test_kfac_update_matches_reference(variant, reference_grads):
    """The plain route (``use_kernels=False``); the kernel route is
    test_torch_kfac_kernels.py."""
    check_update_sequence(variant, False, reference_grads)


def check_update_sequence(variant, use_kernels, reference_grads):
    """Two updates from the same gradients, every period 1: step 0 (stats,
    Brand init and every heavy op — the warmup), step 1 (stats, the Brand
    update and the heavy op on a non-initial state).  Both steps share one
    work mask, so the reference compiles its update once."""
    jc, tc = configs(variant, use_kernels, T_updt=1, T_brand=1, T_inv=1,
                     T_rsvd=1, T_corct=1)
    jparams, jloss, jtaps, ttaps, acts, gp, gprobe = reference_grads
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
                _close_rel(ts.M, js.M, 2e-3, f"step {k} {name}.{side} M")
        assert (tst.step, tst.n_stats, tst.phase) == (
            int(jst.step), int(jst.n_stats), int(jst.phase))


