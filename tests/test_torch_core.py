"""The port's optimizer core held against the JAX package on the same
numpy inputs: mode policy, work schedule, buckets, the Brand update, the
RSVD with the reference's Gaussian draws injected, the Alg-6 correction
with its column draws injected, and damped preconditioning.

Factor states are compared as U·diag(D)·Uᵀ, never column by column:
degenerate eigenpairs rotate.  Tolerance: fp32 on both sides,
atol = rtol = 2e-3 (the reference's fp32 kernel-parity tolerance) unless
a test states otherwise.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import brand as jbrand  # noqa: E402
from repro.core import kfac as jkfac  # noqa: E402
from repro.core import kfactor as jkf  # noqa: E402
from repro.core import policy as jpolicy  # noqa: E402
from repro.core import precond as jprecond  # noqa: E402
from repro.core import rsvd as jrsvd  # noqa: E402
from repro.models.cnn import VggConfig as JVggConfig, make_vgg as jmake_vgg  # noqa: E402,E501
from repro_torch.core import brand as tbrand  # noqa: E402
from repro_torch.core import kfac as tkfac  # noqa: E402
from repro_torch.core import kfactor as tkf  # noqa: E402
from repro_torch.core import policy as tpolicy  # noqa: E402
from repro_torch.core import precond as tprecond  # noqa: E402
from repro_torch.core import rsvd as trsvd  # noqa: E402

TOL = dict(atol=2e-3, rtol=2e-3)
CPU = torch.device("cpu")
PAPER_VARIANTS = ("kfac", "rkfac", "bkfac", "brkfac", "bkfacc")


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **(tol or TOL))


def _recon(U, D):
    U, D = np.asarray(U, np.float64), np.asarray(D, np.float64)
    return (U * D[..., None, :]) @ np.swapaxes(U, -1, -2)


def _psd(rng, *shape, rank=None):
    d = shape[-1]
    X = rng.standard_normal(shape[:-1] + (rank or d,))
    return (X @ np.swapaxes(X, -1, -2) / (rank or d)).astype(np.float32)


def _tspec(js):
    """The port's KFactorSpec with the reference spec's fields."""
    fields = {f.name: getattr(js, f.name)
              for f in dataclasses.fields(js) if f.name != "mode"}
    return tkf.KFactorSpec(mode=tkf.Mode(js.mode.value), **fields)


# ---------------------------------------------------------------------------
# policy
# ---------------------------------------------------------------------------

# the boundaries of tests/test_policy.py: d = r + n_stat (strict), the
# memory gate d = max_dense_dim (inclusive), the tiny override d = r + r_o
@pytest.mark.parametrize("variant", jpolicy.VARIANTS)
def test_select_mode_matches_reference(variant):
    cases = []
    for r, r_o, gate, n_stat in ((32, 10, 1024, 64), (256, 10, 8192, 32),
                                 (10_000, 10, 100_000, 64), (32, 10, 16, 64),
                                 (230, 10, 4096, 256)):
        for d in sorted({8, 20, 42, 43, 64, r + n_stat - 1, r + n_stat,
                         r + n_stat + 1, r + r_o, r + r_o + 1, gate,
                         gate + 1, 2048, 4096, 16384}):
            cases.append((r, r_o, gate, n_stat, d))
    for r, r_o, gate, n_stat, d in cases:
        jc = jpolicy.PolicyConfig(variant=variant, r=r, r_o=r_o,
                                  max_dense_dim=gate)
        tc = tpolicy.PolicyConfig(variant=variant, r=r, r_o=r_o,
                                  max_dense_dim=gate)
        want = jpolicy.select_mode(jc, d, n_stat).value
        assert tpolicy.select_mode(tc, d, n_stat).value == want, \
            (variant, r, r_o, gate, n_stat, d)
        assert _tspec(jpolicy.make_factor_spec(jc, d, n_stat)) == \
            tpolicy.make_factor_spec(tc, d, n_stat)
    assert tpolicy.heavy_period_field(variant) == \
        jpolicy.heavy_period_field(variant)
    assert tpolicy.has_light(variant) == jpolicy.has_light(variant)


def test_unknown_variant_raises():
    with pytest.raises(ValueError, match="unknown K-FAC variant"):
        tpolicy.select_mode(tpolicy.PolicyConfig(variant="sgd"), 64, 8)


# ---------------------------------------------------------------------------
# buckets and schedule on the paper's VGG taps
# ---------------------------------------------------------------------------

def _paper_taps():
    *_, jtaps = jmake_vgg(JVggConfig(stages=(64, 128, 256, 512, 512),
                                     fc_hidden=2048, n_stat=256))
    ttaps = {n: tkfac.TapInfo(param_path=t.param_path, d_in=t.d_in,
                              d_out=t.d_out, stack=t.stack, n_stat=t.n_stat)
             for n, t in jtaps.items()}
    return jtaps, ttaps


def _configs(variant, stagger, **kw):
    common = dict(T_updt=5, T_inv=25, T_brand=5, T_rsvd=25, T_corct=25,
                  stagger=stagger, stagger_splits=3, **kw)
    return (jkfac.KfacConfig(policy=jpolicy.PolicyConfig(
                variant=variant, r=230, max_dense_dim=4096), **common),
            tkfac.KfacConfig(policy=tpolicy.PolicyConfig(
                variant=variant, r=230, max_dense_dim=4096), **common))


@pytest.mark.parametrize("variant", PAPER_VARIANTS)
def test_paper_vgg_buckets_match_reference(variant):
    jtaps, ttaps = _paper_taps()
    jcfg, tcfg = _configs(variant, False)
    jopt = jkfac.Kfac(jcfg, jtaps)
    topt = tkfac.Kfac(tcfg, ttaps, device=CPU)
    assert len(jopt.factor_buckets) == len(topt.factor_buckets)
    for jb, tb in zip(jopt.factor_buckets, topt.factor_buckets):
        assert _tspec(jb.spec) == tb.spec
        assert jb.total == tb.total
        assert [dataclasses.astuple(e) for e in jb.entries] == \
            [dataclasses.astuple(e) for e in tb.entries]
    assert len(jopt.precond_buckets) == len(topt.precond_buckets)
    for jb, tb in zip(jopt.precond_buckets, topt.precond_buckets):
        assert (_tspec(jb.spec_a), _tspec(jb.spec_g), jb.total) == \
            (tb.spec_a, tb.spec_g, tb.total)
        assert [e.name for e in jb.entries] == [e.name for e in tb.entries]
    if variant == "bkfac":
        # the slice's own configuration, as listed in ROADMAP.md
        got = [(b.spec.d, b.spec.mode.value, b.total)
               for b in topt.factor_buckets]
        assert got == [(10, "evd", 1), (27, "evd", 1), (64, "evd", 2),
                       (128, "evd", 2), (256, "rsvd", 2), (512, "brand", 4),
                       (576, "brand", 2), (1152, "brand", 2),
                       (2048, "brand", 2), (2304, "brand", 2),
                       (4608, "brand", 3), (16384, "brand", 1)]
        assert len(topt.precond_buckets) == 10


@pytest.mark.parametrize("stagger", [False, True])
@pytest.mark.parametrize("variant", PAPER_VARIANTS)
def test_step_work_matches_reference(variant, stagger):
    jtaps, ttaps = _paper_taps()
    jcfg, tcfg = _configs(variant, stagger)
    js = jkfac.Kfac(jcfg, jtaps).scheduler()
    ts = tkfac.Kfac(tcfg, ttaps, device=CPU).scheduler()
    assert ts.cycle == js.cycle
    assert [(u.bucket, u.lo, u.hi, u.phase) for u in ts.units] == \
        [(u.bucket, u.lo, u.hi, u.phase) for u in js.units]
    for k in range(2 * js.cycle + 3):
        jw, tw = js.work(k), ts.work(k)
        assert (tw.stats, tw.light, tw.heavy, tw.launch, tw.land,
                tw.label) == (jw.stats, jw.light, jw.heavy, jw.launch,
                              jw.land, jw.label), (variant, stagger, k)


def test_unported_paths_raise():
    _, ttaps = _paper_taps()
    for kw, match in ((dict(bucketed=False), "bucketed"),
                      (dict(async_heavy=True), "async")):
        _, tcfg = _configs("bkfac", False, **kw)
        with pytest.raises(NotImplementedError, match=match):
            tkfac.Kfac(tcfg, ttaps, device=CPU)
    with pytest.raises(NotImplementedError, match="nskfac"):
        tkfac.Kfac(tkfac.KfacConfig(policy=tpolicy.PolicyConfig(
            variant="nskfac")), ttaps, device=CPU)


# ---------------------------------------------------------------------------
# factor numerics
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("stack,d,r,n", [((), 40, 8, 6), ((3,), 64, 16, 12)])
def test_sym_brand_update_matches_reference(stack, d, r, n, use_kernel):
    rng = np.random.default_rng(d + r)
    U = np.linalg.qr(rng.standard_normal(stack + (d, r)))[0].astype(
        np.float32)
    D = np.sort(np.abs(rng.standard_normal(stack + (r,))), -1)[..., ::-1]
    D = np.ascontiguousarray(D, np.float32)
    A = rng.standard_normal(stack + (d, n)).astype(np.float32)
    jU, jD = jbrand.sym_brand_update(jnp.asarray(U), jnp.asarray(D),
                                     jnp.asarray(A), use_kernel=use_kernel)
    tU, tD = tbrand.sym_brand_update(_t(U), _t(D), _t(A),
                                     use_kernel=use_kernel)
    _close(tD, jD)
    _close(_recon(tU, tD), _recon(jU, jD))
    # and it is the exact EVD of U D Uᵀ + A Aᵀ
    _close(_recon(tU, tD), _recon(U, D) + A @ np.swapaxes(A, -1, -2))


@pytest.mark.parametrize("use_kernel", [False, True])
def test_ea_brand_step_and_init_match_reference(use_kernel):
    rng = np.random.default_rng(11)
    X0 = rng.standard_normal((2, 48, 10)).astype(np.float32)
    X1 = rng.standard_normal((2, 48, 10)).astype(np.float32)
    jU, jD = jbrand.init_from_factor(jnp.asarray(X0), 26)
    tU, tD = tbrand.init_from_factor(_t(X0), 26)
    _close(_recon(tU, tD), _recon(jU, jD))
    jU, jD = jbrand.ea_brand_step(jU, jD, jnp.asarray(X1), 0.95, 16,
                                  use_kernel=use_kernel)
    tU, tD = tbrand.ea_brand_step(tU, tD, _t(X1), 0.95, 16,
                                  use_kernel=use_kernel)
    _close(_recon(tU, tD), _recon(jU, jD))


def test_rsvd_psd_with_injected_omega():
    rng = np.random.default_rng(3)
    M = _psd(rng, 2, 64, 64)
    key = jax.random.PRNGKey(7)
    keys = jax.random.split(key, 2)
    k = 16 + 4
    omega = np.stack([np.asarray(jax.random.normal(kk, (64, k)))
                      for kk in keys])
    want = [jrsvd.rsvd_psd(jnp.asarray(M[i]), 16, 4, keys[i], 2, pad_to=20)
            for i in range(2)]
    tU, tD = trsvd.rsvd_psd(_t(M), 16, 4, 2, pad_to=20, omega=_t(omega))
    assert tU.shape == (2, 64, 20) and tD.shape == (2, 20)
    for i, (jU, jD) in enumerate(want):
        _close(tD[i], jD)
        _close(_recon(tU[i], tD[i]), _recon(jU, jD))
    eU, eD = trsvd.exact_evd(_t(M), r=12, pad_to=20)
    jU, jD = jrsvd.exact_evd(jnp.asarray(M[0]), r=12, pad_to=20)
    _close(_recon(eU[0], eD[0]), _recon(jU, jD))


def test_light_correction_with_injected_columns():
    rng = np.random.default_rng(5)
    jspec = jkf.KFactorSpec(d=40, r=12, n_stat=8, mode=jkf.Mode.BRAND_CORR,
                            n_crc=6)
    M = _psd(rng, 2, 40, 40)
    U = np.linalg.qr(rng.standard_normal((2, 40, 20)))[0].astype(np.float32)
    D = np.sort(np.abs(rng.standard_normal((2, 20))), -1)[..., ::-1].astype(
        np.float32)
    aux = np.zeros((2, 3), np.float32)
    keys = jax.random.split(jax.random.PRNGKey(1), 2)
    idx = np.stack([np.asarray(jax.random.choice(k, 12, shape=(6,),
                                                 replace=False))
                    for k in keys])
    want = [jkf.light_correction(jspec, jkf.KFactorState(
        U=jnp.asarray(U[i]), D=jnp.asarray(D[i]), M=jnp.asarray(M[i]),
        aux=jnp.asarray(aux[i])), keys[i]) for i in range(2)]
    got = tkf.light_correction(_tspec(jspec), tkf.KFactorState(
        U=_t(U), D=_t(D), M=_t(M), aux=_t(aux)), idx=torch.from_numpy(idx))
    for i, w in enumerate(want):
        _close(_recon(got.U[i], got.D[i]), _recon(w.U, w.D))
    # drawn (not injected): n_crc distinct columns among the first r
    cols = tkf.draw_correction_idx(_tspec(jspec), 4,
                                   torch.Generator().manual_seed(0))
    assert cols.shape == (4, 6)
    assert all(len(set(row.tolist())) == 6 and max(row) < 12 for row in cols)


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("continuation", [True, False])
def test_precondition_with_damping_matches_reference(continuation,
                                                     use_kernel):
    rng = np.random.default_rng(9)
    J = rng.standard_normal((3, 24, 40)).astype(np.float32)
    Ug = np.linalg.qr(rng.standard_normal((3, 24, 10)))[0].astype(np.float32)
    Ua = np.linalg.qr(rng.standard_normal((3, 40, 14)))[0].astype(np.float32)
    Dg = np.abs(rng.standard_normal((3, 10))).astype(np.float32)
    Da = np.abs(rng.standard_normal((3, 14))).astype(np.float32)
    Da[:, -4:] = 0.0                        # zero-padded (rank-deficient)
    want = jprecond.precondition_with_damping(
        *map(jnp.asarray, (J, Ug, Dg, Ua, Da)), jnp.float32(0.1),
        continuation=continuation, use_kernel=use_kernel)
    got = tprecond.precondition_with_damping(
        *map(_t, (J, Ug, Dg, Ua, Da)), 0.1, continuation=continuation,
        use_kernel=use_kernel)
    _close(got, want)


def test_spectrum_continuation_and_damping_floor():
    D = np.array([[3.0, 1.0, 0.5, 0.0], [0.0, 0.0, 0.0, 0.0]], np.float32)
    lam = np.array([0.1, 0.0], np.float32)
    jD, jl = jprecond.spectrum_continuation(jnp.asarray(D), jnp.asarray(lam))
    tD, tl = tprecond.spectrum_continuation(_t(D), _t(lam))
    _close(tD, jD)
    _close(tl, jl)
    # λ = 0 stays finite through the split (the _LAM_EPS floor)
    want = jprecond.lowrank_inv_diag(jnp.asarray(D), jnp.asarray(lam))
    got = tprecond.lowrank_inv_diag(_t(D), _t(lam))
    assert torch.isfinite(got).all()
    _close(got, want)
    _close(tprecond.damping_from_spectrum(_t(D), 0.1),
           jprecond.damping_from_spectrum(jnp.asarray(D), 0.1))


def test_ea_update_m_matches_reference():
    rng = np.random.default_rng(21)
    M = _psd(rng, 2, 12, 12)
    X = rng.standard_normal((2, 12, 5)).astype(np.float32)
    for first in (True, False):
        want = jkf.ea_update_m(jnp.asarray(M), jnp.asarray(X), 0.9, first)
        _close(tkf.ea_update_m(_t(M), _t(X), 0.9, first), want)
        _close(tkf.ea_update_m_kernel(_t(M), _t(X), 0.9, first), want)


@pytest.mark.parametrize("continuation", [True, False])
def test_linear_precondition_matches_reference(continuation):
    """Alg 8 (plain torch in this slice; its kernel route is later)."""
    rng = np.random.default_rng(13)
    G = rng.standard_normal((2, 20, 6)).astype(np.float32)
    A = rng.standard_normal((2, 30, 6)).astype(np.float32)
    Ug = np.linalg.qr(rng.standard_normal((2, 20, 8)))[0].astype(np.float32)
    Ua = np.linalg.qr(rng.standard_normal((2, 30, 9)))[0].astype(np.float32)
    Dg = np.abs(rng.standard_normal((2, 8))).astype(np.float32)
    Da = np.abs(rng.standard_normal((2, 9))).astype(np.float32)
    want = jprecond.precondition_linear_with_damping(
        *map(jnp.asarray, (G, A, Ug, Dg, Ua, Da)), jnp.float32(0.1),
        continuation=continuation)
    got = tprecond.precondition_linear_with_damping(
        *map(_t, (G, A, Ug, Dg, Ua, Da)), 0.1, continuation=continuation)
    _close(got, want)


def test_schedules_and_clip_match_reference():
    from repro.optim import base as jbase
    from repro_torch.optim import base as tbase
    for jf, tf in ((jbase.paper_lr_schedule(50), tbase.paper_lr_schedule(50)),
                   (jbase.paper_damping_schedule(50),
                    tbase.paper_damping_schedule(50)),
                   (jbase.constant(0.3), tbase.constant(0.3))):
        for step in (0, 1, 99, 100, 101, 149, 150, 650, 2000, 5000):
            assert abs(tf(step) - float(jf(step))) < 1e-7, step
    tree = {"a": np.full((3,), 2.0, np.float32),
            "b": np.full((2, 2), -1.0, np.float32)}
    want = jbase.clip_by_global_norm({k: jnp.asarray(v)
                                      for k, v in tree.items()},
                                     jnp.asarray(0.5))
    got = tbase.clip_by_global_norm({k: _t(v) for k, v in tree.items()},
                                    0.5)
    for k in tree:
        _close(got[k], want[k])
