"""The widest error-ratio cases of the 3xTF32 emulation: ``a_perp`` at
fc0 and every Brand bucket, both ``precond_fused`` passes at every precond
bucket, and ``lowrank_apply`` at every launch of the paths in both
layouts — each within ``RATIO`` × an fp32 matmul's error against float64.

The emulation, its one-thread fixture and the shapes are those of
``tests/test_torch_tf32x3.py`` (its docstring says what they show); the
cases live in a file of their own so that parallel test workers, which
keep a file on one worker, can run them beside the rest.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.tools.tc_shapes import LOWRANK_CASES  # noqa: E402
from repro_torch.tools.tc_shapes import PRECOND_BUCKETS  # noqa: E402
from test_torch_tf32x3 import (BRAND, H100_TC_RESIDENT,  # noqa: E402,F401
                               RATIO, _errors, _t, one_thread,
                               tf32x3_matmul, tf32x3_split)


@pytest.mark.parametrize("b,d", BRAND)
def test_tf32x3_a_perp_error_within_ratio(b, d):
    rng = np.random.default_rng(d + b)
    rows = min(d, 2048)
    U = np.linalg.qr(rng.standard_normal((b, d, 486)))[0][:, :rows, :230]
    A = _t(rng.standard_normal((b, rows, 256)))
    U = _t(U)
    C = tref.ut_a(U, A).contiguous()
    exact = A.double() - U.double() @ C.double()
    emu, plain = _errors(A - tf32x3_matmul(U, C), exact,
                         tref.a_perp(A, U, C))
    assert emu <= RATIO * plain, (emu, plain)


# ---------------------------------------------------------------------------
# the two precond_fused passes
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _precond_operands(b, p, d, wg, wa):
    """J, U_g (orthonormal columns), s_g, U_a, s_a, 1/λ_g, 1/λ_a of one
    bucket, in fp32 (made once: the panel and the apply cases share
    them)."""
    rng = np.random.default_rng(400 + p + d)
    orth = lambda *s: _t(np.linalg.qr(rng.standard_normal(s))[0])
    neg = lambda *s: _t(-np.abs(rng.standard_normal(s)))
    return (_t(rng.standard_normal((b, p, d))), orth(b, p, wg), neg(b, wg),
            orth(b, d, wa), neg(b, wa), 1.0 - neg(b), 1.0 - neg(b))


def _tc_plan(M, N, K, batch):
    return _build.tc_plan(M, N, K, batch, H100_TC_RESIDENT.__getitem__)


@pytest.mark.parametrize("b,p,d,wg,wa", PRECOND_BUCKETS)
def test_tf32x3_precond_panel_error_within_ratio(b, p, d, wg, wa):
    """Cg = diag(s_g) U_gᵀ J through the emulated AT launch, K = p kept and
    split as the plan of the real shape says; columns cut to 128."""
    J, Ug, sg = _precond_operands(b, p, d, wg, wa)[:3]
    J = J[..., :128]
    emu = tf32x3_split(Ug.mT, J, *_tc_plan(wg, d, p, b)) * sg[..., :, None]
    exact = (Ug.double().mT @ J.double()) * sg.double()[..., :, None]
    e, pl = _errors(emu, exact, tref.precond_panel(Ug, J, sg))
    assert e <= RATIO * pl, (e, pl)


@pytest.mark.parametrize("b,p,d,wg,wa", PRECOND_BUCKETS)
def test_tf32x3_precond_apply_error_within_ratio(b, p, d, wg, wa):
    """S = (W U_a) diag(s_a) U_aᵀ + W/λ_a, W = U_g Cg + J/λ_g, as the three
    launches compute it (each product split as the plan of the real shape
    says; S's U_a read as Bᵀ), from the plain version's Cg; rows cut to
    256, every K (w_g, d, w_a) kept."""
    J, Ug, sg, Ua, sa, ilg, ila = _precond_operands(b, p, d, wg, wa)
    rows = min(p, 256)
    Cg = tref.precond_panel(Ug, J, sg)
    J, Ug = J[:, :rows], Ug[:, :rows]
    ig, ia = ilg[:, None, None], ila[:, None, None]
    W = tf32x3_split(Ug, Cg, *_tc_plan(p, d, wg, b)) + ig * J
    Tw = tf32x3_split(W, Ua, *_tc_plan(p, wa, d, b)) * sa[..., None, :]
    emu = tf32x3_split(Tw, Ua.mT, *_tc_plan(p, d, wa, b)) + ia * W
    W64 = Ug.double() @ Cg.double() + ig.double() * J.double()
    Ua64 = Ua.double()
    exact = (((W64 @ Ua64) * sa.double()[..., None, :]) @ Ua64.mT
             + ia.double() * W64)
    e, pl = _errors(emu, exact, tref.precond_apply(J, Ug, Cg, Ua, sa,
                                                   1.0 / ilg, 1.0 / ila))
    assert e <= RATIO * pl, (e, pl)


@pytest.mark.parametrize("cols", [False, True], ids=["rows", "columns"])
@pytest.mark.parametrize("b,p,d,w,path_cols", LOWRANK_CASES)
def test_tf32x3_lowrank_apply_error_within_ratio(b, p, d, w, path_cols,
                                                 cols):
    """Y = (X U) diag(s) Uᵀ + X/λ as the two launches compute it, X by
    rows (T = X U, column scale s; Y = T Uᵀ, U read as Bᵀ, addend X) or by
    columns (C = Uᵀ Z, row scale s, U read as Aᵀ; Yᵀ = U C, addend Z), each
    product split as the plan of the real shape says.  Every K (d, then w)
    kept; Y cut to a block of at most 64 of its p rows and 1024 of its d
    columns."""
    rng = np.random.default_rng(500 + p + d + w)
    rows, keep = min(p, 64), min(d, 1024)
    X = _t(rng.standard_normal((b, rows, d)))
    U = _t(np.linalg.qr(rng.standard_normal((b, d, w)))[0])
    # s = (D + λ)⁻¹ − 1/λ, λ = 0.1 max D, as the path damps a spectrum: on
    # the span the two terms nearly cancel (wholly where w = d)
    D = -np.sort(-np.abs(rng.standard_normal((b, w))) - 0.01, axis=-1)
    lam = 0.1 * D[:, :1]
    s, il = _t(1.0 / (D + lam) - 1.0 / lam), _t(1.0 / lam[:, 0])
    ia = il[:, None, None]
    if cols:
        Z = X.mT
        C = tf32x3_split(U.mT, Z, *_tc_plan(w, p, d, b)) * s[..., :, None]
        emu = (tf32x3_split(U[:, :keep], C, *_tc_plan(d, p, w, b))
               + ia * Z[:, :keep]).mT
    else:
        T = tf32x3_split(X, U, *_tc_plan(p, w, d, b)) * s[..., None, :]
        emu = (tf32x3_split(T, U[:, :keep].mT, *_tc_plan(p, d, w, b))
               + ia * X[..., :keep])
    X64, U64 = X.double(), U.double()
    exact = (((X64 @ U64) * s.double()[..., None, :]) @ U64[:, :keep].mT
             + ia.double() * X64[..., :keep])
    plain = tref.lowrank_apply(X, U, s, 1.0 / il)[..., :keep]
    e, pl = _errors(emu, exact, plain)
    assert e <= RATIO * pl, (e, pl)
