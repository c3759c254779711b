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
ALL_VARIANTS = PAPER_VARIANTS + ("nskfac",)


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


@pytest.mark.parametrize("variant", ALL_VARIANTS)
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
    if variant == "nskfac":
        # every factor with d ≤ 4096 is NS; the memory gate degrades the
        # four wider ones to BRAND, so two precond buckets are mixed
        got = [(b.spec.d, b.spec.mode.value, b.total)
               for b in topt.factor_buckets]
        assert got == [(10, "ns", 1), (27, "ns", 1), (64, "ns", 2),
                       (128, "ns", 2), (256, "ns", 2), (512, "ns", 4),
                       (576, "ns", 2), (1152, "ns", 2), (2048, "ns", 2),
                       (2304, "ns", 2), (4608, "brand", 3),
                       (16384, "brand", 1)]
        mixed = [([e.name for e in b.entries], b.spec_a.mode.value,
                  b.spec_g.mode.value) for b in topt.precond_buckets
                 if b.spec_a.mode != b.spec_g.mode]
        assert mixed == [(["conv3_1", "conv4_0", "conv4_1"], "brand", "ns"),
                         (["fc0"], "brand", "ns")]


@pytest.mark.parametrize("stagger", [False, True])
@pytest.mark.parametrize("variant", ALL_VARIANTS)
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
    """Every path of the single-device optimizer builds: the async heavy
    pipeline (bucketed only: per tap it raises ValueError, as in the
    reference), the per-tap path, nskfac and linear-apply taps."""
    _, ttaps = _paper_taps()
    _, tcfg = _configs("brkfac", False, async_heavy=True, heavy_lag=2)
    assert tkfac.Kfac(tcfg, ttaps, device=CPU)._async_buckets
    with pytest.raises(ValueError, match="bucketed"):
        tkfac.Kfac(dataclasses.replace(tcfg, bucketed=False), ttaps,
                   device=CPU)
    _, tcfg = _configs("bkfac", False, bucketed=False)
    assert not tkfac.Kfac(tcfg, ttaps, device=CPU).cfg.bucketed
    _, tcfg = _configs("nskfac", False)
    opt = tkfac.Kfac(tcfg, ttaps, device=CPU)
    assert any(b.spec.mode is tkf.Mode.NS for b in opt.factor_buckets)
    lin = {n: dataclasses.replace(t, linear_apply=n in ("fc0", "fc1"))
           for n, t in ttaps.items()}
    _, tcfg = _configs("bkfac", False)
    opt = tkfac.Kfac(tcfg, lin, device=CPU)
    assert [[e.name for e in b.entries] for b in opt.precond_buckets
            if b.linear_apply] == [["fc1"], ["fc0"]]


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_clip_in_place_equals_pure(dtype):
    """``clip_by_global_norm_`` scales its input in place to the bits of
    ``clip_by_global_norm``, which leaves its input as it was."""
    from repro_torch.optim import base as tbase
    g = torch.Generator().manual_seed(0)
    tree = {"a": torch.randn((5, 3), generator=g).to(dtype),
            "b": torch.randn((7,), generator=g).to(dtype)}
    before = {k: x.clone() for k, x in tree.items()}
    want = tbase.clip_by_global_norm(tree, 0.5)
    for k in tree:
        assert torch.equal(tree[k], before[k]), k
    got = tbase.clip_by_global_norm_(tree, 0.5)
    for k in tree:
        assert got[k] is tree[k] and got[k].dtype == dtype
        assert torch.equal(got[k], want[k]), k
        assert not torch.equal(got[k], before[k]), k


# ---------------------------------------------------------------------------
# NS-KFAC: ns_overwrite on the cases of tests/test_ns_inverse.py
# ---------------------------------------------------------------------------

def _ns_psd(seed, d, scale=1.0, decay=0.8):
    """tests/test_ns_inverse.py's _psd, as numpy."""
    lam = scale * np.power(np.arange(1, d + 1, dtype=np.float32), -decay)
    Q, _ = np.linalg.qr(np.asarray(jax.random.normal(
        jax.random.PRNGKey(seed), (d, d))))
    return ((Q * lam) @ Q.T).astype(np.float32)


def _ns_adversarial(d):
    """Top eigenvector orthogonal to the power iteration's all-ones start
    (tests/test_ns_inverse.py's _adversarial_m): plain NS diverges."""
    u1 = np.zeros(d, np.float32)
    u1[0], u1[1] = 1.0, -1.0
    u1 /= np.sqrt(2.0)
    P = np.outer(u1, u1)
    return (2.0 * P + (np.eye(d) - P)).astype(np.float32)


def _ns_states(M, U=None):
    U = np.zeros_like(M) if U is None else U
    D = np.zeros(M.shape[:-1], np.float32)
    aux = np.zeros(M.shape[:-2] + (jkf.AUX_WIDTH,), np.float32)
    return (jkf.KFactorState(U=jnp.asarray(U), D=jnp.asarray(D),
                             M=jnp.asarray(M), aux=jnp.asarray(aux)),
            tkf.KFactorState(U=_t(U), D=_t(D), M=_t(M), aux=_t(aux)))


def _ns_specs(d, **kw):
    js = jkf.KFactorSpec(d=d, r=16, n_stat=8, mode=jkf.Mode.NS, **kw)
    return js, _tspec(js)


def _rel_fro(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _check_ns(tout, jout, fallback):
    """The port's refresh against the reference's: U to 1e-4 in relative
    Frobenius norm (the tolerance tests/test_ns_inverse.py holds the
    reference's U to against the exact inverse), λ̂ to 1e-5, the
    residual flag the same, and D all-zero."""
    assert _rel_fro(tout.U, jout.U) < 1e-4
    _close(tout.aux[..., tkf.AUX_LAM], jout.aux[..., jkf.AUX_LAM],
           atol=0, rtol=1e-5)
    t_res = np.asarray(tout.aux[..., tkf.AUX_RES])
    j_res = np.asarray(jout.aux[..., jkf.AUX_RES])
    assert np.array_equal(~(t_res < tkf._NS_RES_MAX), ~(j_res < 0.5))
    assert np.array_equal(~(t_res < tkf._NS_RES_MAX), np.asarray(fallback))
    assert not torch.any(tout.D)


@pytest.mark.parametrize("case", ["cold", "zero_init", "zero_iters",
                                  "divergence"])
def test_ns_overwrite_matches_reference(case):
    d = {"cold": 256, "zero_init": 128, "zero_iters": 96,
         "divergence": 128}[case]
    M = (_ns_adversarial(d) if case == "divergence"
         else _ns_psd({"cold": 0, "zero_init": 3, "zero_iters": 5}[case], d))
    js, ts = _ns_specs(d, ns_iters=0 if case == "zero_iters" else 8)
    jst, tst = _ns_states(M)
    jout, tout = jkf.ns_overwrite(js, jst), tkf.ns_overwrite(ts, tst)
    _check_ns(tout, jout, case in ("zero_iters", "divergence"))
    if case in ("cold", "zero_init"):
        assert float(tout.aux[tkf.AUX_RES]) < 1e-3


def test_ns_warm_start_matches_reference():
    """tests/test_ns_inverse.py's warm-start case: after an EA drift the
    stale inverse passes the guard and K = 2 suffices."""
    d = 192
    M0 = _ns_psd(1, d)
    M1 = (0.95 * M0 + 0.05 * _ns_psd(2, d, scale=0.05)).astype(np.float32)
    js8, ts8 = _ns_specs(d, ns_iters=8)
    jst, tst = _ns_states(M0)
    jsrc, tsrc = jkf.ns_overwrite(js8, jst), tkf.ns_overwrite(ts8, tst)
    js2, ts2 = _ns_specs(d, ns_iters=2)
    jst, _ = _ns_states(M1, np.asarray(jsrc.U))
    _, tst = _ns_states(M1, tsrc.U.numpy())
    jout, tout = jkf.ns_overwrite(js2, jst), tkf.ns_overwrite(ts2, tst)
    _check_ns(tout, jout, False)
    cold = tkf.ns_overwrite(ts2, _ns_states(M1)[1])
    assert float(tout.aux[tkf.AUX_RES]) < 0.01 * float(
        cold.aux[tkf.AUX_RES])


def test_ns_fallback_is_per_slot():
    """One diverging slot in a bucket: the healthy slot's result is bit
    for bit the one it gets beside a healthy sibling (torch's batched and
    single matmuls differ in rounding, so the comparison is at the same
    batch size), the bad slot takes the LU inverse — both as the
    reference's (through heavy_overwrite_batched and the per-tap program
    inverse_rep_step)."""
    d = 128
    good, bad = _ns_psd(4, d), _ns_adversarial(d)
    js, ts = _ns_specs(d)
    healthy = tkf.ns_overwrite(ts, _ns_states(np.stack([good, good]))[1])
    jst, tst = _ns_states(np.stack([good, bad]))
    jout = jkf.heavy_overwrite_batched(js, jst,
                                       jnp.zeros((2, 2), jnp.uint32))
    tout = tkf.heavy_overwrite_batched(ts, tst)
    assert torch.equal(tout.U[0], healthy.U[0])
    _check_ns(tout, jout, [False, True])
    X = torch.zeros((2, d, 8))
    rep = tkf.inverse_rep_step(ts, tst, X, first=False, heavy=True)
    assert torch.equal(rep.U, tout.U)
    assert torch.equal(tkf.inverse_rep_step(ts, tst, X, first=False,
                                            heavy=False).U, tst.U)


# ---------------------------------------------------------------------------
# dense (NS) sides and the Alg-8 kernel route in the preconditioning
# ---------------------------------------------------------------------------

def _dense_inv(rng, b, d):
    """A symmetric positive definite "dense damped inverse" stack."""
    return np.linalg.inv(_psd(rng, b, d, d) + np.eye(d, dtype=np.float32)
                         ).astype(np.float32)


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("dense", ["g", "a", "both"])
@pytest.mark.parametrize("linear", [False, True])
def test_dense_and_linear_precondition_match_reference(linear, dense,
                                                       use_kernel):
    rng = np.random.default_rng(17)
    dg, da, n, wg, wa = 20, 30, 6, 8, 9
    dense_g, dense_a = dense in ("g", "both"), dense in ("a", "both")
    Ug = (_dense_inv(rng, 2, dg) if dense_g else np.linalg.qr(
        rng.standard_normal((2, dg, wg)))[0].astype(np.float32))
    Ua = (_dense_inv(rng, 2, da) if dense_a else np.linalg.qr(
        rng.standard_normal((2, da, wa)))[0].astype(np.float32))
    Dg = (np.zeros((2, dg), np.float32) if dense_g
          else np.abs(rng.standard_normal((2, wg))).astype(np.float32))
    Da = (np.zeros((2, da), np.float32) if dense_a
          else np.abs(rng.standard_normal((2, wa))).astype(np.float32))
    flags = dict(continuation=True, use_kernel=use_kernel, dense_g=dense_g,
                 dense_a=dense_a)
    if linear:
        G = rng.standard_normal((2, dg, n)).astype(np.float32)
        A = rng.standard_normal((2, da, n)).astype(np.float32)
        want = jprecond.precondition_linear_with_damping(
            *map(jnp.asarray, (G, A, Ug, Dg, Ua, Da)), jnp.float32(0.1),
            **flags)
        got = tprecond.precondition_linear_with_damping(
            *map(_t, (G, A, Ug, Dg, Ua, Da)), 0.1, **flags)
    else:
        J = rng.standard_normal((2, dg, da)).astype(np.float32)
        want = jprecond.precondition_with_damping(
            *map(jnp.asarray, (J, Ug, Dg, Ua, Da)), jnp.float32(0.1),
            **flags)
        got = tprecond.precondition_with_damping(
            *map(_t, (J, Ug, Dg, Ua, Da)), 0.1, **flags)
    _close(got, want)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_apply_inv_left_right_kernel_route_matches_reference(use_kernel):
    """apply_inv_right/left through ops.lowrank_apply (``use_kernel``),
    with a zero factor — the nskfac gated-BRAND case: U = 0, D = 0, so λ
    sits at the _LAM_EPS floor and the application is J/λ."""
    rng = np.random.default_rng(19)
    J = rng.standard_normal((2, 12, 40)).astype(np.float32)
    U = np.linalg.qr(rng.standard_normal((2, 40, 7)))[0].astype(np.float32)
    D = np.abs(rng.standard_normal((2, 7))).astype(np.float32)
    lam = np.array([0.2, 0.05], np.float32)
    for Uc, Dc, lc in ((U, D, lam), (np.zeros_like(U), np.zeros_like(D),
                                     np.zeros_like(lam))):
        want_r = jprecond.apply_inv_right(*map(jnp.asarray, (J, Uc, Dc, lc)),
                                          use_kernel=use_kernel)
        got_r = tprecond.apply_inv_right(*map(_t, (J, Uc, Dc, lc)),
                                         use_kernel=use_kernel)
        _close(got_r / float(np.abs(want_r).max()),
               np.asarray(want_r) / float(np.abs(want_r).max()))
        Jl = np.swapaxes(J, -1, -2).copy()
        want_l = jprecond.apply_inv_left(*map(jnp.asarray, (Jl, Uc, Dc, lc)),
                                         use_kernel=use_kernel)
        got_l = tprecond.apply_inv_left(*map(_t, (Jl, Uc, Dc, lc)),
                                        use_kernel=use_kernel)
        _close(got_l / float(np.abs(want_l).max()),
               np.asarray(want_l) / float(np.abs(want_l).max()))
