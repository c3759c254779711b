"""The port's gradient compression (``distributed/compress.py``) against the
reference's, on the CPU.

Inputs are numpy arrays from a seed; the reference's seeded cold-start
bases (``jax.random.normal(PRNGKey(m · 1315423911 + n), (n, q))``) are
injected into the port, whose own come from a torch generator.
Tolerances are the reference tests': 1e-6 for a first round
(``tests/test_mesh2d.py``'s atol, which holds the package to itself; across
the two packages, whose fp32 sums run in other orders, it is 1e-6 of each
compared tensor's largest entry: readings ≤ 5.3e-7) and atol 1e-4 for
``approx + err = G`` (``tests/test_fault_tolerance.py``); a second,
warm-started round at 1e-5 of the scale.  Q factors are compared up to the
sign of each column (Householder QR's sign choice; P Qᵀ does not depend on
it).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.distributed import compress as jc  # noqa: E402
from repro_torch.distributed import compress as tc  # noqa: E402

ROUND1 = 1e-6
ROUND2 = 1e-5
EF = 1e-4


def _np(x):
    return np.asarray(x.detach() if isinstance(x, torch.Tensor) else x,
                      np.float64)


def _t(x):
    return torch.as_tensor(np.array(x, np.float32))


def _basis(shape, rank):
    """The reference's cold-start basis for a leaf of ``shape``."""
    m = shape[0] if len(shape) == 2 else int(np.prod(shape[:-1]))
    n = shape[-1]
    q = min(rank, m, n)
    return np.asarray(jax.random.normal(
        jax.random.PRNGKey(m * 1315423911 + n), (n, q)))


def _close(got, want, rel):
    """Largest difference within ``rel`` of ``want``'s largest entry."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= rel, f"max err {err:.3g} of the scale > {rel}"


def _close_q(got, want, rel):
    """Equal up to the sign of each column."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    s = np.sign(np.sum(got * want, axis=0))
    s[s == 0] = 1.0
    _close(got * s, want, rel)


def _normal(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


CASES = [
    ((64, 32), 4, 1),
    ((48, 48), 4, 1),
    ((3, 40, 24), 8, 1),        # stacked: leading axes fold into rows
    ((100, 5), 2, 2),
]


@pytest.mark.parametrize("shape,rank,iters", CASES)
def test_compress_cold_start_equals_reference(shape, rank, iters):
    G, err = _normal(0, shape), _normal(1, shape, 0.1)
    jcfg = jc.CompressConfig(rank=rank, n_power_iter=iters)
    tcfg = tc.CompressConfig(rank=rank, n_power_iter=iters)
    jP, jQ, jerr = jc.compress(jnp.asarray(G), jnp.asarray(err), None, jcfg)
    tP, tQ, terr = tc.compress(_t(G), _t(err), None, tcfg,
                               basis=_t(_basis(shape, rank)))
    _close(tc.decompress(tP, tQ, G.shape), jc.decompress(jP, jQ, G.shape),
           ROUND1)
    _close(terr, jerr, ROUND1)
    _close_q(tQ, jQ, ROUND1)
    assert tuple(tP.shape) == tuple(jP.shape)


@pytest.mark.parametrize("shape,rank,iters", CASES)
def test_compress_warm_start_equals_reference(shape, rank, iters):
    """A given ``q_prev`` of the right shape is the start: no basis."""
    G, err = _normal(2, shape), np.zeros(shape, np.float32)
    q_prev = _normal(3, (shape[-1], min(rank, int(np.prod(shape[:-1])),
                                        shape[-1])))
    jcfg = jc.CompressConfig(rank=rank, n_power_iter=iters)
    tcfg = tc.CompressConfig(rank=rank, n_power_iter=iters)
    jP, jQ, jerr = jc.compress(jnp.asarray(G), jnp.asarray(err),
                               jnp.asarray(q_prev), jcfg)
    tP, tQ, terr = tc.compress(_t(G), _t(err), _t(q_prev), tcfg)
    _close(terr, jerr, ROUND1)
    _close_q(tQ, jQ, ROUND1)


def test_new_err_is_g_minus_approx_as_the_reference_computes():
    """The reference returns ``g − P Qᵀ`` (its code at ``compress.py:67``),
    not ``(g + err) − P Qᵀ`` as its module docstring reads: the port
    mirrors the code, so the fed-back error drops out of the residual."""
    shape, cfg = (32, 16), tc.CompressConfig(rank=2)
    G, err = _normal(4, shape), _normal(5, shape)
    P, Q, new_err = tc.compress(_t(G), _t(err), None, cfg,
                                basis=_t(_basis(shape, 2)))
    approx = tc.decompress(P, Q, shape)
    np.testing.assert_allclose(_np(new_err), G - _np(approx), atol=ROUND1)
    assert np.abs(_np(new_err) - (G + err - _np(approx))).max() > 0.1
    _, _, jerr = jc.compress(jnp.asarray(G), jnp.asarray(err), None,
                             jc.CompressConfig(rank=2))
    _close(new_err, jerr, ROUND1)


def test_lossless_for_lowrank():
    """The port's version of tests/test_fault_tolerance.py's case."""
    G = _normal(6, (64, 4)) @ _normal(7, (4, 32))
    P, Q, new_err = tc.compress(_t(G), torch.zeros(64, 32), None,
                                tc.CompressConfig(rank=4))
    np.testing.assert_allclose(_np(tc.decompress(P, Q, G.shape)), G,
                               atol=1e-3)
    assert float(torch.linalg.norm(new_err)) < 1e-3


def test_error_feedback_preserves_signal():
    G = _normal(8, (48, 48))
    P, Q, err = tc.compress(_t(G), torch.zeros(48, 48), None,
                            tc.CompressConfig(rank=4))
    np.testing.assert_allclose(_np(tc.decompress(P, Q, G.shape) + err), G,
                               atol=EF)


TREE = {"a": (64, 32), "b": (2, 40, 24), "c": (4, 4), "d": (300,)}


def _tree(seed, scale=1.0):
    return {k: _normal(seed + i, s, scale)
            for i, (k, s) in enumerate(TREE.items())}


def test_compress_tree_two_rounds_equals_reference():
    """Two rounds over a tree with compressible leaves (a 2D and a stacked
    3D one), one below ``min_size`` and a 1D one: the approximations, the
    error feedback and the warm Q carry after each round."""
    jcfg = jc.CompressConfig(rank=4, min_size=256)
    tcfg = tc.CompressConfig(rank=4, min_size=256)
    init = _tree(10)
    js = jc.init_state({k: jnp.asarray(v) for k, v in init.items()}, jcfg)
    ts = tc.init_state({k: _t(v) for k, v in init.items()}, tcfg,
                       bases={k: _t(_basis(s, 4)) for k, s in TREE.items()
                              if k in ("a", "b")})
    assert set(ts.q) == set(TREE) and ts.q["c"].numel() == 0 \
        and ts.q["d"].numel() == 0
    for k in ("a", "b"):
        np.testing.assert_array_equal(_np(ts.q[k]), _np(js.q[k]))
    for rnd, tol in ((0, ROUND1), (1, ROUND2)):
        grads = _tree(20 + 10 * rnd)
        ja, js = jc.compress_tree({k: jnp.asarray(v)
                                   for k, v in grads.items()}, js, jcfg)
        tg = {k: _t(v) for k, v in grads.items()}
        old = ts
        ta, ts = tc.compress_tree(tg, ts, tcfg)
        # the inputs were consumed leaf by leaf
        assert not tg and not old.err and not old.q
        assert list(ta) == list(TREE)
        for k in TREE:
            _close(ta[k], ja[k], tol)
            _close(ts.err[k], js.err[k], tol)
            if k in ("a", "b"):
                _close_q(ts.q[k], js.q[k], tol)
                np.testing.assert_allclose(
                    _np(ta[k]) + _np(ts.err[k]), grads[k], atol=EF)
            else:       # passed through, zero error, sentinel kept
                np.testing.assert_array_equal(_np(ta[k]), grads[k])
                assert float(ts.err[k].abs().max()) == 0.0
                assert ts.q[k].numel() == 0


def test_compress_batched_equals_reference():
    G = _normal(30, (3, 40, 24))
    jP, jQ = jc.compress_batched(jnp.asarray(G), 4, n_power_iter=1)
    tP, tQ = tc.compress_batched(_t(G), 4, n_power_iter=1,
                                 basis=_t(_basis((40, 24), 4)))
    assert tuple(tP.shape) == (3, 40, 4) and tuple(tQ.shape) == (3, 24, 4)
    _close(tP @ tQ.transpose(-1, -2), jP @ jnp.swapaxes(jQ, -1, -2),
           ROUND1)
    for i in range(3):
        _close_q(tP[i], jP[i], ROUND1)
        _close_q(tQ[i], jQ[i], ROUND1)


def test_seeded_basis_is_a_function_of_the_shape():
    a = tc.seeded_basis(64, 32, 4)
    assert torch.equal(a, tc.seeded_basis(64, 32, 4))
    assert not torch.equal(a, tc.seeded_basis(32, 64, 4)[:32])
    cfg = tc.CompressConfig(rank=4, min_size=1)
    st = tc.init_state({"w": torch.zeros(2, 32, 16)}, cfg)
    assert torch.equal(st.q["w"], tc.seeded_basis(64, 16, 4))
    assert torch.equal(st.err["w"], torch.zeros(2, 32, 16))


# the port's versions of tests/test_mesh2d.py::TestWarmStartCompression's
# three fast cases


def test_round1_matches_stateless_cold_start():
    G = _t(_normal(40, (64, 32)))
    cfg = tc.CompressConfig(rank=4, min_size=1)
    cstate = tc.init_state({"w": G}, cfg)
    approx, _ = tc.compress_tree({"w": G}, cstate, cfg)
    P, Q, _ = tc.compress(G, torch.zeros_like(G), None, cfg)
    np.testing.assert_allclose(_np(approx["w"]),
                               _np(tc.decompress(P, Q, G.shape)),
                               atol=ROUND1)


def test_state_carries_q_and_error():
    G = _t(_normal(41, (64, 32)))
    cfg = tc.CompressConfig(rank=4, min_size=1)
    cstate = tc.init_state({"w": G}, cfg)
    q0 = cstate.q["w"].clone()
    _, s1 = tc.compress_tree({"w": G}, cstate, cfg)
    assert tuple(s1.q["w"].shape) == (32, 4)
    # the carried Q is the data-dependent factor, not the seed
    assert float((s1.q["w"] - q0).abs().max()) > 1e-3
    assert float(torch.linalg.norm(s1.err["w"])) > 0


def test_warm_start_sharpens_basis_across_rounds():
    """On a fixed matrix with a decaying spectrum, re-entering the last
    round's Q makes each round another power iteration: the rank-q error
    falls, while cold restarts stay pinned."""
    s = np.diag(2.0 ** -np.arange(32, dtype=np.float32))
    G = _t(_normal(42, (64, 32)) @ s)
    cfg = tc.CompressConfig(rank=4, min_size=1)
    zero = torch.zeros_like(G)

    def rounds(warm, n=6):
        qc, errs = None, []
        for _ in range(n):
            P, Q, _ = tc.compress(G, zero, qc if warm else None, cfg)
            if warm:
                qc = Q
            A = tc.decompress(P, Q, G.shape)
            errs.append(float(torch.linalg.norm(G - A)
                              / torch.linalg.norm(G)))
        return errs

    warm, cold = rounds(True), rounds(False)
    assert all(abs(c - cold[0]) < 1e-5 for c in cold)     # pinned
    assert warm[-1] < cold[-1] - 1e-6, (warm, cold)
    assert warm[-1] <= min(warm) + 1e-6
