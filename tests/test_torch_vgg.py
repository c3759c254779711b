"""The port's training slice held against the JAX package on a small VGG
that still has EVD, RSVD and BRAND buckets, built in both packages from
the same weights and batches: the forward pass, activations and probe
gradients, and a 12-step B-KFAC loss trajectory.  ``test_torch_kfac.py``
reuses the set-up here for one update sequence per paper variant.

The reference's random draws (RSVD test matrices, Alg-6 columns) are
recomputed along its key chain and injected into the port.  Factor states
are compared as U·diag(D)·Uᵀ (degenerate eigenpairs rotate).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import kfac as jkfac
from repro.core import kfactor as jkf
from repro.core import policy as jpolicy
from repro.data.synthetic import ImageStream as JImageStream
from repro.models.cnn import VggConfig as JVggConfig, make_vgg as jmake_vgg
from repro.optim import base as jbase
from repro_torch.convert import params_from_jax
from repro_torch.core import kfac as tkfac
from repro_torch.core import policy as tpolicy
from repro_torch.models.cnn import VggConfig, make_vgg
from repro_torch.optim import base as tbase

CPU = torch.device("cpu")
PAPER_VARIANTS = ("kfac", "rkfac", "bkfac", "brkfac", "bkfacc")
# stages (8, 16), fc_hidden 64, n_stat 32, r 16: EVD d = 8, 10, 16, RSVD
# d = 27 and BRAND d = 64, 72, 144, 4096 under bkfac (max_dense_dim 1024
# keeps the 4096-wide FC0 factor low-rank under every variant)
SMALL = dict(stages=(8, 16), fc_hidden=64, n_stat=32)
RANK = 16
BATCH = 16


def jax_model(seed=0):
    init, loss_fn, _, taps = jmake_vgg(JVggConfig(**SMALL))
    return init(jax.random.PRNGKey(seed)), loss_fn, taps


def torch_model(jparams):
    model, taps = make_vgg(VggConfig(**SMALL), device=CPU)
    model.load_params(params_from_jax(jax.tree_util.tree_map(
        np.asarray, jparams), device=CPU))
    return model, taps


def jax_batches(n, batch=BATCH, seed=0):
    stream = JImageStream(batch=batch, seed=seed)
    return [stream.batch_at(i) for i in range(n)]


def to_torch_batch(b):
    x, y = b
    return (torch.from_numpy(np.array(x, np.float32)),
            torch.from_numpy(np.array(y, np.int64)))


def configs(variant, use_kernels, **periods):
    kw = dict(lr=None, damping_phi=None, clip=0.5, weight_decay=7e-4,
              use_kernels=use_kernels, **periods)
    jc = jkfac.KfacConfig(
        policy=jpolicy.PolicyConfig(variant=variant, r=RANK,
                                    max_dense_dim=1024),
        **{**kw, "lr": jbase.constant(0.1),
           "damping_phi": jbase.constant(0.1),
           "fallback_lr": jbase.constant(3e-3)})
    tc = tkfac.KfacConfig(
        policy=tpolicy.PolicyConfig(variant=variant, r=RANK,
                                    max_dense_dim=1024),
        **{**kw, "lr": tbase.constant(0.1),
           "damping_phi": tbase.constant(0.1),
           "fallback_lr": tbase.constant(3e-3)})
    return jc, tc


def reference_draws(opt: jkfac.Kfac, rng, work):
    """The heavy ops' random inputs exactly as the reference draws them:
    ``split(rng, n_buckets)`` → ``split(bucket_key, total)`` → per slot
    ``normal(key, (d, r + r_o))`` (RSVD range finder) or
    ``choice(key, r, (n_crc,), replace=False)`` (Alg-6 columns)."""
    out = {}
    bkeys = jax.random.split(rng, len(opt.factor_buckets))
    for bi, (bkey, b) in enumerate(zip(bkeys, opt.factor_buckets)):
        if not work.heavy[bi]:
            continue
        keys = jax.random.split(bkey, b.total)
        s = b.spec
        if s.mode in (jkf.Mode.RSVD, jkf.Mode.BRAND_RSVD):
            k = min(s.r + s.r_o, s.d)
            out[bi] = torch.from_numpy(np.stack([np.asarray(
                jax.random.normal(kk, (s.d, k), dtype=jnp.float32))
                for kk in keys]))
        elif s.mode is jkf.Mode.BRAND_CORR:
            out[bi] = torch.from_numpy(np.stack([np.asarray(
                jax.random.choice(kk, s.r, shape=(s.n_crc,), replace=False))
                for kk in keys]).astype(np.int64))
    return out


def recon(st):
    """U·diag(D)·Uᵀ in float64 numpy (from either package's state)."""
    U = np.asarray(st.U, np.float64)
    D = np.asarray(st.D, np.float64)
    return (U * D[..., None, :]) @ np.swapaxes(U, -1, -2)


def tap_dict(taps):
    return {n: dataclasses.asdict(t) for n, t in taps.items()}


from repro.models import layers as jlayers  # noqa: E402
from repro.train import loop as jloop  # noqa: E402
from repro_torch.models import cnn as tcnn  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.train import loop as tloop  # noqa: E402


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _tensors(d):
    return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in
            d.items()}


def _close_rel(got, want, rel, what="", floor=1e-6):
    """max |got − want| ≤ rel · max |want| + floor: a tolerance relative to
    the tensor's own scale (entries near zero carry no relative meaning).
    The absolute floor covers tensors whose true value is zero, such as a
    conv bias before batch norm, whose gradient is fp32 noise (~1e-7)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max()
    assert err <= rel * scale + floor, \
        f"{what}: max err {err:.3g} > {rel} × {scale:.3g} + {floor}"


def _jax_grads(jparams, jloss, jtaps, batch):
    probes = jlayers.make_probes(jtaps)
    (loss, acts), (gp, gprobe) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jparams, probes, batch)
    return loss, acts, gp, gprobe


def test_im2col_equals_reference_patches():
    from repro.models.cnn import im2col as jim2col
    x = np.random.default_rng(0).standard_normal((2, 6, 5, 3)).astype(
        np.float32)
    np.testing.assert_array_equal(
        tcnn.im2col(torch.from_numpy(x), 3).numpy(),
        np.asarray(jim2col(jnp.asarray(x), 3)))


@pytest.mark.parametrize("shape,n_stat", [
    ((40, 12), 32),          # flat: the first n_stat rows
    ((12, 12), 32),          # flat, fewer rows than n_stat: zero-padded
    ((3, 7, 12), 8),         # (B, T, d): first ceil(n_stat/B) tokens each
    ((4, 2, 12), 16)])       # (B, T, d) with fewer rows than n_stat
def test_tapped_matmul_matches_reference(shape, n_stat):
    rng = np.random.default_rng(sum(shape) + n_stat)
    x = rng.standard_normal(shape).astype(np.float32)
    W = rng.standard_normal((12, 5)).astype(np.float32)
    g = rng.standard_normal(shape[:-1] + (5,)).astype(np.float32)

    def jf(W, x, probe):
        y, act = jlayers.tapped_matmul(W, x, probe, n_stat)
        return jnp.sum(y * jnp.asarray(g)), (y, act)

    (_, (y, act)), gprobe = jax.value_and_grad(jf, argnums=2, has_aux=True)(
        jnp.asarray(W), jnp.asarray(x), jnp.zeros((n_stat, 5)))
    probe = torch.zeros((n_stat, 5), requires_grad=True)
    ty, tact = tlayers.tapped_matmul(torch.from_numpy(W),
                                     torch.from_numpy(x), probe, n_stat)
    (tg,) = torch.autograd.grad((ty * torch.from_numpy(g)).sum(), probe)
    # fp32 products of length 12: 1e-5 of each tensor's scale
    _close_rel(ty.detach(), y, 1e-5, "y")
    _close_rel(tact.detach(), act, 1e-5, "act")
    _close_rel(tg, gprobe, 1e-5, "probe grad")


def test_forward_acts_and_grads_match_reference():
    # fp32 forward + backward through 4 im2col convs, batch norm and two
    # FC layers in two libraries: 1e-4 of each tensor's own scale
    jparams, jloss, jtaps = jax_model()
    model, ttaps = torch_model(jparams)
    assert tap_dict(ttaps) == tap_dict(jtaps)
    jb = jax_batches(1)[0]
    loss, acts, gp, gprobe = _jax_grads(jparams, jloss, jtaps, jb)
    tl, tacts, tgp, tgprobe = tloop.kfac_grads(
        model.loss, model.params(), tlayers.make_probes(ttaps, device=CPU),
        to_torch_batch(jb))
    _close_rel(tl, loss, 1e-5, "loss")
    assert set(tacts) == set(acts) == set(tgprobe)
    for name in acts:
        _close_rel(tacts[name], acts[name], 1e-4, f"acts[{name}]")
        _close_rel(tgprobe[name], gprobe[name], 1e-4, f"probe[{name}]")
    want = params_from_jax(_np_tree(gp), device=CPU)
    assert set(tgp) == set(want)
    for k in want:
        _close_rel(tgp[k], want[k], 1e-4, f"grad[{k}]")


def _float64_grads(model, ttaps, batch):
    """The port's gradients in float64 on the CPU: the witness both
    packages' fp32 gradients are held against."""
    p64 = {k: v.detach().double().requires_grad_()
           for k, v in model.params().items()}
    pr64 = {k: v.double().requires_grad_()
            for k, v in tlayers.make_probes(ttaps, device=CPU).items()}
    x, y = to_torch_batch(batch)
    return tloop.kfac_grads(model.loss, p64, pr64, (x.double(), y))[2]


def test_grads_match_float64_witness():
    """On batch 0 of the stream (seed 0) the reference's *jitted* backward
    differs from float64 by up to 1.3e-2 of a conv weight's gradient, while
    its eager backward and the port agree with float64 to 5.1e-6 and
    1.5e-6 (readings:
    ``python tests/test_torch_vgg.py``).  This holds the two fp32 eager
    gradients against the float64 witness, which is why the trajectory
    tests below run the reference's loop eagerly (``jit=False``)."""
    jparams, jloss, jtaps = jax_model()
    model, ttaps = torch_model(jparams)
    jb = jax_batches(1)[0]
    want = _float64_grads(model, ttaps, jb)
    _, _, gp, _ = _jax_grads(jparams, jloss, jtaps, jb)
    jgrads = params_from_jax(_np_tree(gp), device=CPU)
    tgrads = tloop.kfac_grads(model.loss, model.params(),
                              tlayers.make_probes(ttaps, device=CPU),
                              to_torch_batch(jb))[2]
    # fp32 forward + backward against float64: 1e-5 of each gradient's
    # scale (measured ≤ 5.1e-6); the floor covers the pre-batch-norm conv
    # biases, whose true gradient is 0 (float64 gives ~1e-16)
    for k in want:
        _close_rel(jgrads[k], want[k].detach(), 1e-5, f"reference {k}")
        _close_rel(tgrads[k], want[k].detach(), 1e-5, f"port {k}")


#: a step size at which fp32 rounding stays at rounding level over the
#: run: at the example's lr 0.1, clip 0.5 and fallback lr 3e-3 the
#: reference's jitted loop and its own eager loop part by 1e-3 in the
#: loss at step 2 and by up to 3.5e-2 later, with the continuation on
#: (readings: ``python tests/test_torch_vgg.py``), so no port can be held
#: closer than that there.  Here, with the continuation off, they part
#: by ≤ 1.8e-3 (batch 0's jitted gradient, above), and the port and the
#: eager loop by ≤ 3.5e-7
QUIET = dict(lr=0.03, clip=0.1, fallback_lr=1e-3)


def _trajectories(n, continuation, quiet=True, jit=False, seed=0):
    """B-KFAC with use_kernels=True on the small VGG, n steps of the same
    batches from the same weights: the reference's own
    ``run_kfac_training`` (eager unless ``jit``) and the port's, with the
    reference's draws recomputed along its key chain (``PRNGKey(seed)``,
    one ``split`` per step) and injected.  Returns (reference, port)
    losses."""
    periods = dict(T_updt=2, T_brand=2, T_inv=4, T_rsvd=4, T_corct=4)
    jc, tc = configs("bkfac", True, **periods)
    jkw = dict(spectrum_continuation=continuation)
    tkw = dict(spectrum_continuation=continuation)
    if quiet:
        jkw.update(lr=jbase.constant(QUIET["lr"]), clip=QUIET["clip"],
                   fallback_lr=jbase.constant(QUIET["fallback_lr"]))
        tkw.update(lr=tbase.constant(QUIET["lr"]), clip=QUIET["clip"],
                   fallback_lr=tbase.constant(QUIET["fallback_lr"]))
    jc = dataclasses.replace(jc, **jkw)
    tc = dataclasses.replace(tc, **tkw)
    jparams, jloss, jtaps = jax_model()
    model, ttaps = torch_model(jparams)
    jopt, topt = jkfac.Kfac(jc, jtaps), tkfac.Kfac(tc, ttaps, device=CPU)
    jb = jax_batches(n)
    sched, rng, draws = jopt.scheduler(), jax.random.PRNGKey(seed), {}
    for k in range(n):
        rng, sub = jax.random.split(rng)
        draws[k] = reference_draws(jopt, sub, sched.work(k))
    _, jlosses = jloop.run_kfac_training(jloss, jopt, jparams, jb,
                                         n_tokens=BATCH, seed=seed, jit=jit)
    _, tlosses = tloop.run_kfac_training(
        model.loss, topt, model.params(), [to_torch_batch(b) for b in jb],
        n_tokens=BATCH, seed=seed, device=CPU, draws=draws.get)
    return np.asarray(jlosses), np.asarray(tlosses)


def test_bkfac_kernel_trajectory_matches_reference():
    """12 steps of B-KFAC with use_kernels=True (heavy, light and idle
    steps, T_inv = 4): the port's ``run_kfac_training`` against the
    reference's, eagerly, at the QUIET step size and with the spectrum
    continuation off — the continuation shifts λ by the smallest positive
    eigenvalue, and fc1's G factor has an exact null direction (softmax)
    whose eigenvalue sits at rounding level, so its sign picks λ; the
    next test holds the continuation over a shorter run."""
    jlosses, tlosses = _trajectories(12, continuation=False)
    assert np.all(np.isfinite(tlosses))
    # fp32 rounding over 12 steps in two libraries (measured ≤ 3.5e-7)
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-4)


def test_bkfac_kernel_trajectory_with_continuation_matches_reference():
    """The same with the spectrum continuation on (the default), over the
    first four steps (heavy, idle, light, idle), before the rounding-level
    eigenvalue above can part the two runs (measured ≤ 3.5e-7 here, 1.2e-5
    at step 4 and 1.4e-4 at step 5; the reference's jitted loop parts from
    its own eager loop by 1.1e-4 at step 2 in this setting)."""
    jlosses, tlosses = _trajectories(4, continuation=True)
    assert np.all(np.isfinite(tlosses))
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-4)


def _readings():
    """The measurements quoted in the docstrings above and in PERF.md."""
    import json
    jparams, jloss, jtaps = jax_model()
    model, ttaps = torch_model(jparams)
    jit_grads = jax.jit(lambda p, b: _jax_grads(p, jloss, jtaps, b))
    for bi, jb in enumerate(jax_batches(3)):
        want = _float64_grads(model, ttaps, jb)
        got = {"jit": params_from_jax(_np_tree(jit_grads(jparams, jb)[2]),
                                      device=CPU),
               "eager": params_from_jax(_np_tree(
                   _jax_grads(jparams, jloss, jtaps, jb)[2]), device=CPU),
               "port": tloop.kfac_grads(
                   model.loss, model.params(),
                   tlayers.make_probes(ttaps, device=CPU),
                   to_torch_batch(jb))[2]}
        row = {}
        for name, g in got.items():
            # worst relative error over the gradients with a real scale
            # (the pre-batch-norm biases' true gradient is 0)
            row[name] = max(
                float((g[k].detach().double() - want[k]).abs().max()
                      / want[k].abs().max())
                for k in want if float(want[k].abs().max()) > 1e-8)
        print(json.dumps({"grads_vs_float64": f"batch {bi}", **row}),
              flush=True)
    for cont, quiet in ((False, True), (True, True), (True, False)):
        jl, tl = _trajectories(12, cont, quiet)
        jj, _ = _trajectories(12, cont, quiet, jit=True)
        rel = lambda a, b: (np.abs(a - b) / np.abs(b)).tolist()
        print(json.dumps({"continuation": cont, "quiet": quiet,
                          "port_vs_reference_eager": rel(tl, jl),
                          "reference_jit_vs_eager": rel(jj, jl)}),
              flush=True)


if __name__ == "__main__":
    _readings()
