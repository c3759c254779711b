"""The port's kernel layer held against the JAX package.

Two links per kernel: the plain version in ``repro_torch/kernels/ref.py``
against ``repro/kernels/ref.py`` and against the Pallas kernel run in
interpret mode on the CPU (exactly as the reference's own tests run it),
on the same numpy inputs; then the dispatch rules of
``repro_torch/kernels/ops.py``.  The CUDA kernels themselves are held
against the plain versions by ``test_torch_cuda.py`` (card only) and by
``chip_smoke.py``.

Tolerance: fp32 throughout, atol = rtol = 2e-3 — the tolerance of
tests/test_kernels.py and tests/test_cholqr.py for fp32 kernel-vs-oracle
parity (two BLAS libraries sum in different orders) — except ``ns_step``,
held at tests/test_ns_inverse.py's atol 1e-3, rtol 1e-4.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.brand_panel import brand_panel_batched_pallas  # noqa: E402
from repro.kernels.cholqr import cholqr2_batched_pallas  # noqa: E402
from repro.kernels.ea_syrk import ea_syrk_batched_pallas  # noqa: E402
from repro.kernels.lowrank_apply import lowrank_apply_batched_pallas  # noqa: E402,E501
from repro.kernels.ns_inverse import gemm_update_batched_pallas  # noqa: E402
from repro.kernels.precond_fused import precond_fused_pallas  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels import brand_panel as tbp  # noqa: E402
from repro_torch.kernels import cholqr as tcq  # noqa: E402
from repro_torch.kernels import ea_syrk as tea  # noqa: E402
from repro_torch.kernels import lowrank_apply as tla  # noqa: E402
from repro_torch.kernels import ns_inverse as tns  # noqa: E402
from repro_torch.kernels import precond_fused as tpf  # noqa: E402

TOL = dict(atol=2e-3, rtol=2e-3)


def _rng(seed):
    return np.random.default_rng(seed)


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **(tol or TOL))


def _orth(rng, *shape):
    return np.linalg.qr(rng.standard_normal(shape))[0].astype(np.float32)


def _inv_diag(rng, *shape):
    D = np.sort(np.abs(rng.standard_normal(shape)) + 0.1, axis=-1)[..., ::-1]
    lam = 0.1 * D[..., 0]
    return (1.0 / (D + lam[..., None]) - 1.0 / lam[..., None]).astype(
        np.float32), lam.astype(np.float32)


# ---------------------------------------------------------------------------
# plain versions vs the reference oracles (stacked, unaligned, deficient)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stack,d,n,first", [
    ((), 27, 40, False), ((2, 3), 16, 8, True), ((2,), 10, 256, False)])
def test_ea_syrk_matches_reference(stack, d, n, first):
    rng = _rng(d + n)
    M = rng.standard_normal(stack + (d, d)).astype(np.float32)
    X = rng.standard_normal(stack + (d, n)).astype(np.float32)
    want = jref.ea_syrk(jnp.asarray(M), jnp.asarray(X), 0.95, first)
    _close(tref.ea_syrk(_t(M), _t(X), 0.95, first), want)
    _close(ops.ea_syrk(_t(M), _t(X), 0.95, first), want)


@pytest.mark.parametrize("stack,d,r,n", [
    ((), 27, 23, 16), ((3,), 64, 8, 24), ((2, 2), 40, 23, 5)])
def test_brand_panel_matches_reference(stack, d, r, n):
    rng = _rng(d * r + n)
    U = _orth(rng, *stack, d, r)
    A = rng.standard_normal(stack + (d, n)).astype(np.float32)
    C_want, P_want = jref.brand_panel(jnp.asarray(U), jnp.asarray(A))
    for C, P in (tref.brand_panel(_t(U), _t(A)),
                 ops.brand_panel(_t(U), _t(A))):
        _close(C, C_want)
        _close(P, P_want)
    _close(tref.ut_a(_t(U), _t(A)), C_want)
    _close(tref.a_perp(_t(A), _t(U), _t(np.asarray(C_want))), P_want)


@pytest.mark.parametrize("floor,mode", [
    (64 * 1.19e-7, "tr"), (0.25, "max")])
def test_gram_inv_sqrt_both_floors(floor, mode):
    rng = _rng(7)
    A = rng.standard_normal((2, 50, 12)).astype(np.float32)
    A[..., -3:] = A[..., :3] * 1e-5          # near-null directions
    G = np.einsum("bdn,bdm->bnm", A, A)
    R_want, B_want = jref.gram_inv_sqrt(jnp.asarray(G), floor, mode)
    R, B = tref.gram_inv_sqrt(_t(G), floor, mode)
    # compare the represented operators (eigenbases may rotate inside
    # degenerate eigenspaces; R and B are rotation-invariant)
    _close(R, R_want)
    _close(B @ _t(G) @ B, np.asarray(B_want) @ G @ np.asarray(B_want))


@pytest.mark.parametrize("stack,d,n,deficient", [
    ((), 27, 10, False), ((2,), 64, 16, True), ((2, 2), 40, 8, False)])
def test_cholqr2_matches_reference(stack, d, n, deficient):
    rng = _rng(d + n)
    A = rng.standard_normal(stack + (d, n)).astype(np.float32)
    if deficient:
        A[..., n // 2:] = A[..., :n - n // 2] * 2.0   # rank n/2
    Q_want, R_want = jref.cholqr2(jnp.asarray(A))
    for Q, R in (tref.cholqr2(_t(A)), ops.cholqr2(_t(A))):
        # Q spans the same subspace: compare projectors Q Qᵀ, and Q R ≈ A
        _close(Q @ Q.mT, np.asarray(Q_want) @ np.swapaxes(
            np.asarray(Q_want), -1, -2))
        _close(Q @ R, np.asarray(Q_want) @ np.asarray(R_want))
        _close(Q @ R, A, atol=1e-3, rtol=1e-3)
    _close(tref.syrk_tn(_t(A)), jref.syrk_tn(jnp.asarray(A)))
    B = rng.standard_normal(stack + (n, n)).astype(np.float32)
    _close(tref.rinv_apply(_t(A), _t(B)),
           jref.rinv_apply(jnp.asarray(A), jnp.asarray(B)))


@pytest.mark.parametrize("stack,p,d,wg,wa", [
    ((), 27, 64, 27, 64), ((2,), 40, 10, 23, 10), ((2, 2), 16, 24, 8, 12)])
def test_precond_fused_matches_reference(stack, p, d, wg, wa):
    rng = _rng(p * d + wg)
    J = rng.standard_normal(stack + (p, d)).astype(np.float32)
    Ug, Ua = _orth(rng, *stack, p, wg), _orth(rng, *stack, d, wa)
    sg, lam_g = _inv_diag(rng, *stack, wg)
    sa, lam_a = _inv_diag(rng, *stack, wa)
    want = jref.precond_fused(*map(jnp.asarray, (J, Ug, sg, lam_g, Ua, sa,
                                                 lam_a)))
    args = tuple(map(_t, (J, Ug, sg, lam_g, Ua, sa, lam_a)))
    _close(tref.precond_fused(*args), want)
    _close(ops.precond_fused(*args), want)
    # the two halves compose to the whole
    Cg = tref.precond_panel(args[1], args[0], args[2])
    _close(tref.precond_apply(args[0], args[1], Cg, args[4], args[5],
                              args[3], args[6]), want)
    # and lowrank_apply (the apply pass's right half) on its own
    _close(tref.lowrank_apply(args[0], args[4], args[5], args[6]),
           jref.lowrank_apply(*map(jnp.asarray, (J, Ua, sa, lam_a))))


@pytest.mark.parametrize("stack,p,d,w,lam_kind", [
    ((), 256, 256, 64, "scalar"),           # tests/test_kernels.py:76
    ((2, 2), 128, 128, 8, "stack"),         # test_kernels_stacked.py:90
    ((2,), 120, 136, 12, "stack"),
    ((1,), 20, 10, 10, "scalar")])          # fc1's d = 10 G side
def test_lowrank_apply_matches_reference(stack, p, d, w, lam_kind):
    rng = _rng(p + d + w)
    X = rng.standard_normal(stack + (p, d)).astype(np.float32)
    U = _orth(rng, *stack, d, w)
    s = -rng.uniform(0.1, 1.0, stack + (w,)).astype(np.float32)
    lam = (np.float32(0.7) if lam_kind == "scalar"
           else rng.uniform(0.3, 2.0, stack).astype(np.float32))
    want = jref.lowrank_apply(*map(jnp.asarray, (X, U, s, lam)))
    got = tref.lowrank_apply(_t(X), _t(U), _t(s), _t(lam))
    _close(got, want)
    # the ops entry point on a CPU tensor, and a transposed X (the left
    # application's operand) give the same
    _close(ops.lowrank_apply(_t(X), _t(U), _t(s), _t(lam)), want)
    Xt = _t(np.swapaxes(X, -1, -2).copy()).transpose(-1, -2)
    _close(ops.lowrank_apply(Xt, _t(U), _t(s), _t(lam)), want)


@pytest.mark.parametrize("shape", [(128, 128), (3, 128, 128),
                                   (2, 2, 200, 200), (96, 96), (1, 10, 10)])
def test_ns_step_matches_reference(shape):
    """tests/test_ns_inverse.py's shapes and tolerance (atol 1e-3, rtol
    1e-4)."""
    rng = _rng(0)
    A = rng.standard_normal(shape).astype(np.float32)
    M = (A @ np.swapaxes(A, -1, -2) / shape[-1]).astype(np.float32)
    X = (rng.standard_normal(shape) * 0.1).astype(np.float32)
    want = jref.ns_step(jnp.asarray(M), jnp.asarray(X))
    for fn in (tref.ns_step, ops.ns_step):
        _close(fn(_t(M), _t(X)), want, atol=1e-3, rtol=1e-4)
    # a step is two gemm_update launches: T = M̂X (α = 0), 2X − X T
    T = tref.gemm_update(None, _t(M), _t(X), 0.0, 1.0)
    _close(tref.gemm_update(_t(X), _t(X), T, 2.0, -1.0), want,
           atol=1e-3, rtol=1e-4)


def test_mt_and_scal():
    x = _t(_rng(0).standard_normal((2, 3, 4)))
    assert tref.mt(x).shape == (2, 4, 3)
    assert tref.scal(torch.ones(2), x).shape == (2, 1, 1)


# ---------------------------------------------------------------------------
# plain versions vs the Pallas kernels in interpret mode
# ---------------------------------------------------------------------------

def test_ea_syrk_vs_pallas_interpret():
    rng = _rng(1)
    M = rng.standard_normal((2, 128, 128)).astype(np.float32)
    X = rng.standard_normal((2, 128, 128)).astype(np.float32)
    keep = np.float32(0.95)
    got = ea_syrk_batched_pallas(jnp.asarray(M), jnp.asarray(X), keep,
                                 1 - keep, bm=128, bn=128, bk=128,
                                 interpret=True)
    _close(tref.ea_syrk(_t(M), _t(X), 0.95, False), got)


def test_brand_panel_vs_pallas_interpret():
    rng = _rng(2)
    U = _orth(rng, 2, 256, 24)
    A = rng.standard_normal((2, 256, 128)).astype(np.float32)
    C_got, P_got = brand_panel_batched_pallas(jnp.asarray(U), jnp.asarray(A),
                                              bk=128, interpret=True)
    C, P = tref.brand_panel(_t(U), _t(A))
    _close(C, C_got)
    _close(P, P_got)


def test_cholqr2_vs_pallas_interpret():
    rng = _rng(3)
    A = rng.standard_normal((2, 256, 128)).astype(np.float32)
    Q_got, R_got = cholqr2_batched_pallas(jnp.asarray(A), bk=128,
                                          interpret=True)
    Q, R = tref.cholqr2(_t(A))
    _close(Q, Q_got)
    _close(R, R_got)


def test_lowrank_apply_vs_pallas_interpret():
    """Block-aligned, as tests/test_kernels.py:76 runs the kernel (bm = bn
    = bk = 128), and stacked with per-element 1/λ."""
    rng = _rng(6)
    X = rng.standard_normal((2, 256, 256)).astype(np.float32)
    U = _orth(rng, 2, 256, 64)
    s = -rng.uniform(0.1, 1.0, (2, 64)).astype(np.float32)
    lam = np.array([0.7, 1.3], np.float32)
    got = lowrank_apply_batched_pallas(*map(jnp.asarray, (X, U, s, 1 / lam)),
                                       bm=128, bn=128, bk=128,
                                       interpret=True)
    _close(tref.lowrank_apply(_t(X), _t(U), _t(s), _t(lam)), got)


def test_ns_step_vs_pallas_interpret():
    """Both launches of a step through the Pallas kernel (α, β = 0, 1 then
    2, −1), against the port's plain step; atol 1e-3, rtol 1e-4 as in
    tests/test_ns_inverse.py."""
    rng = _rng(7)
    A = rng.standard_normal((3, 128, 128)).astype(np.float32)
    M = (A @ np.swapaxes(A, -1, -2) / 128).astype(np.float32)
    X = (rng.standard_normal((3, 128, 128)) * 0.1).astype(np.float32)
    Mj, Xj = jnp.asarray(M), jnp.asarray(X)
    T = gemm_update_batched_pallas(Xj, Mj, Xj, 0.0, 1.0, bm=128, bn=128,
                                   bk=128, interpret=True)
    got = gemm_update_batched_pallas(Xj, Xj, T, 2.0, -1.0, bm=128, bn=128,
                                     bk=128, interpret=True)
    _close(tref.gemm_update(None, _t(M), _t(X), 0.0, 1.0), T,
           atol=1e-3, rtol=1e-4)
    _close(tref.ns_step(_t(M), _t(X)), got, atol=1e-3, rtol=1e-4)


def test_precond_fused_vs_pallas_interpret():
    rng = _rng(4)
    J = rng.standard_normal((1, 128, 256)).astype(np.float32)
    Ug, Ua = _orth(rng, 1, 128, 16), _orth(rng, 1, 256, 24)
    sg, lam_g = _inv_diag(rng, 1, 16)
    sa, lam_a = _inv_diag(rng, 1, 24)
    got = precond_fused_pallas(*map(jnp.asarray, (J, Ug, sg, 1 / lam_g, Ua,
                                                  sa, 1 / lam_a)),
                               bm=128, bn=128, interpret=True)
    _close(tref.precond_fused(*map(_t, (J, Ug, sg, lam_g, Ua, sa, lam_a))),
           got)


# ---------------------------------------------------------------------------
# dispatch and wrapper checks
# ---------------------------------------------------------------------------

def test_ops_on_cpu_take_the_plain_route(monkeypatch):
    """A CPU tensor never reaches a wrapper: make every wrapper raise and
    check ops still return exactly the plain result."""
    def boom(*a, **k):
        raise AssertionError("a CUDA wrapper was called for a CPU tensor")
    for mod, fn in ((tea, "ea_syrk_batched"), (tbp, "brand_panel_batched"),
                    (tcq, "cholqr2_batched"), (tpf, "precond_fused_batched"),
                    (tns, "ns_step_batched"),
                    (tla, "lowrank_apply_batched")):
        monkeypatch.setattr(mod, fn, boom)
    before = _build.launch_counts()
    rng = _rng(5)
    M = _t(rng.standard_normal((2, 27, 27)))
    X = _t(rng.standard_normal((2, 27, 9)))
    U = _t(_orth(rng, 2, 27, 5))
    assert torch.equal(ops.ea_syrk(M, X, 0.9, False),
                       tref.ea_syrk(M, X, 0.9, False))
    for a, b in zip(ops.brand_panel(U, X), tref.brand_panel(U, X)):
        assert torch.equal(a, b)
    for a, b in zip(ops.cholqr2(X), tref.cholqr2(X)):
        assert torch.equal(a, b)
    assert torch.equal(ops.orthonormalize(X), tref.cholqr2(X)[0])
    s_g, s_a = torch.full((2, 5), -0.5), torch.full((2, 3), -0.25)
    U_a = X.mT[..., :3]
    assert torch.equal(ops.precond_fused(X, U, s_g, 1.0, U_a, s_a, 2.0),
                       tref.precond_fused(X, U, s_g, 1.0, U_a, s_a, 2.0))
    assert torch.equal(ops.ns_step(M, M), tref.ns_step(M, M))
    assert torch.equal(ops.lowrank_apply(X.mT, U, s_g, 1.5),
                       tref.lowrank_apply(X.mT, U, s_g, 1.5))
    assert _build.launch_counts() == before


def _dtype_case(op, rng):
    """(args, non-array args) of one public op at a small shape, as fp32
    numpy arrays; lam, rho, first as plain scalars."""
    M = rng.standard_normal((2, 16, 16))
    X = rng.standard_normal((2, 16, 8))
    U = _orth(rng, 2, 16, 4)
    s = -np.abs(rng.standard_normal((2, 4)))
    return {
        "ea_syrk": ((M, X), (0.95, False)),
        "ns_step": ((M @ M.transpose(0, 2, 1) / 16, 0.1 * M), ()),
        "brand_panel": ((U, X), ()),
        "cholqr2": ((X,), ()),
        "orthonormalize": ((X,), ()),
        "lowrank_apply": ((X.transpose(0, 2, 1), U, s), (1.5,)),
        "precond_fused": ((X, U[:, :, :3], s[:, :3], X.transpose(0, 2, 1)[
            ..., :4]), ()),
    }[op]


OPS = ("ea_syrk", "ns_step", "brand_panel", "cholqr2", "orthonormalize",
       "lowrank_apply", "precond_fused")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("op", OPS)
def test_ops_output_dtype_matches_reference(op, dtype):
    """Every public op returns the reference's output dtype (Pallas
    ``out_shape``: the input's, and fp32 for cholqr2's R) for fp32 and bf16
    inputs, on the CPU route; the card's route casts the fp32 kernel output
    back to the same dtype (tests/test_torch_cuda.py's bf16 cases)."""
    arrays, rest = _dtype_case(op, _rng(21))
    jt, tt = getattr(jnp, dtype), getattr(torch, dtype)
    jargs = [jnp.asarray(np.asarray(a, np.float32), jt) for a in arrays]
    targs = [_t(a).to(tt) for a in arrays]
    if op == "precond_fused":     # J, U_g, s_g, λ_g, U_a, s_a, λ_a
        s_a = -np.abs(_rng(22).standard_normal((2, 4)))
        jargs = jargs[:3] + [2.0, jargs[3], jnp.asarray(s_a, jt), 3.0]
        targs = targs[:3] + [2.0, targs[3], _t(s_a).to(tt), 3.0]
    want = getattr(jops, op)(*jargs, *rest)
    got = getattr(ops, op)(*targs, *rest)
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert str(g.dtype).removeprefix("torch.") == str(w.dtype), (
            g.dtype, w.dtype)
        assert tuple(g.shape) == tuple(w.shape)


@pytest.mark.parametrize("bad,match", [
    (dict(dtype=torch.float64), "float32"),
    (dict(shape=(27, 27)), r"\(1, rows, cols\)"),
    (dict(), "CUDA tensor")])
def test_wrapper_rejects_unsupported_input(bad, match):
    shape = bad.get("shape", (1, 27, 27))
    M = torch.zeros(shape, dtype=bad.get("dtype", torch.float32))
    X = torch.zeros((1, 27, 8), dtype=M.dtype)
    with pytest.raises(ValueError, match=match):
        tea.ea_syrk_batched(M, X, 0.5, 0.5)


def test_wrappers_reject_cpu_tensors():
    z = lambda *s: torch.zeros(s)
    with pytest.raises(ValueError, match="CUDA"):
        tbp.ut_a_batched(z(1, 8, 4), z(1, 8, 3))
    with pytest.raises(ValueError, match="CUDA"):
        tbp.a_perp_batched(z(1, 8, 3), z(1, 8, 4), z(1, 4, 3))
    with pytest.raises(ValueError, match="CUDA"):
        tcq.syrk_tn_batched(z(1, 8, 3))
    with pytest.raises(ValueError, match="CUDA"):
        tcq.rinv_apply_batched(z(1, 8, 3), z(1, 3, 3))
    with pytest.raises(ValueError, match="CUDA"):
        tpf.precond_panel_batched(z(1, 8, 2), z(1, 8, 4), z(1, 2))
    with pytest.raises(ValueError, match="CUDA"):
        tns.gemm_update_batched(z(1, 4, 4), z(1, 4, 4), z(1, 4, 4), 2., 1.)
    with pytest.raises(ValueError, match="CUDA"):
        tla.lowrank_apply_batched(z(1, 3, 8), z(1, 8, 2), z(1, 2), z(1))
    with pytest.raises(ValueError, match="contiguous"):
        tcq.syrk_tn_batched(z(1, 3, 8).mT)


#: Blocks of the pipelined GEMM an H100 SXM holds at once in clusters of c
#: with one or two blocks an SM, as (one, two): cudaOccupancyMaxActiveClusters
#: × c at 67.6 KB of shared memory a block (chip_smoke.py prints them).  A
#: cluster sits within one GPC, so clusters of 3 or more reach fewer SMs.
H100_RESIDENT = {1: (132, 264), 2: (132, 264), 3: (117, 237), 4: (120, 248),
                 5: (110, 235), 6: (102, 234), 7: (105, 224), 8: (120, 240)}


#: ut_a at every Brand bucket of the paper VGG's light step (M = r = 230,
#: N = n = 256, K = d, batch = stack) and rinv_apply at every CholeskyQR2
#: panel of the path (M = d, N = K = n) → (splits, cluster)
@pytest.mark.parametrize("M,N,K,batch,want", [
    # fc0: 4 tiles; 28 splits in clusters of 4 put one block on each of 112
    # SMs (64 in clusters of 8 would need 32 clusters; the card holds 30)
    (230, 256, 16384, 1, (28, 4)),
    (230, 256, 4608, 3, (10, 2)),
    (230, 256, 2304, 2, (12, 6)),
    (230, 256, 2048, 2, (12, 6)),
    (230, 256, 1152, 2, (12, 6)),
    (230, 256, 576, 2, (12, 6)),
    (230, 256, 512, 4, (8, 2)),
    (230, 256, 27, 1, (2, 2)),             # 16 + 11: no split left empty
    (16384, 256, 256, 1, (1, 1)),          # rinv_apply at fc0: 256 tiles
    (4608, 256, 256, 3, (1, 1)),
    (2304, 256, 256, 2, (3, 3)),
    (2048, 256, 256, 2, (2, 2)),
    (1152, 256, 256, 2, (3, 3)),
    (576, 256, 256, 2, (4, 4)),
    (512, 256, 256, 4, (4, 2)),
    (256, 240, 240, 2, (8, 8)),            # the RSVD range finder's panel
])
def test_split_k_choice_pipe(M, N, K, batch, want):
    resident = lambda c, per_sm: H100_RESIDENT[c][per_sm - 1]
    splits, cluster = _build.pipe_split(M, N, K, batch, resident)
    assert (splits, cluster) == want
    assert splits % cluster == 0 and cluster <= 8
    # every block resident at once, no split empty
    tiles = _build.pipe_tiles(M, N) * batch
    assert tiles * splits <= resident(cluster, 2)
    kchunk = -(-(-(-K // splits)) // 16) * 16
    assert (splits - 1) * kchunk < K
