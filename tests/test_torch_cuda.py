"""The CUDA kernels against their plain versions, on the card.

Every test here is marked ``cuda`` and skips on a host without a card
(the kernels have no CPU mode).  The file imports no JAX, so it also runs
on the H100 machine, which has none:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerance: fp32 in and out with another summation order than cuBLAS,
atol = rtol = 2e-3 (the reference's fp32 kernel-parity tolerance).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels import brand_panel as tbp  # noqa: E402
from repro_torch.kernels import cholqr as tcq  # noqa: E402
from repro_torch.kernels import ea_syrk as tea  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

TOL = dict(atol=2e-3, rtol=2e-3)


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **(tol or TOL))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


#: (d, n, batch) of ea_syrk: ragged d = 27 and 10 and n = 33, then every
#: dense bucket of the paper VGG's paths with its n = 256 stats rows
#: (B-KFAC's d ≤ 256, NS-KFAC's up to 2304: one cluster, split or not)
EA_CASES = [(27, 256, 1), (256, 256, 2), (10, 33, 3),
            (10, 256, 1), (64, 256, 2), (128, 256, 2), (512, 256, 4),
            (576, 256, 2), (1152, 256, 2), (2048, 256, 2), (2304, 256, 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("d,n,batch", EA_CASES)
def test_cuda_ea_syrk(cuda, d, n, batch):
    """ea_syrk (3xTF32, one triangle of X Xᵀ, each off-diagonal tile
    stored twice) with a non-symmetric M, so that every entry must take
    its own addend: against the plain version, one launch a call, the same
    bits on a second launch."""
    g = torch.Generator(device=cuda).manual_seed(0)
    M = torch.randn((batch, d, d), generator=g, device=cuda)
    X = torch.randn((batch, d, n), generator=g, device=cuda)
    _build.reset_launch_counts()
    got = ops.ea_syrk(M, X, 0.95, False)
    assert _build.launch_counts()["ea_syrk"] == 1
    _close(got.cpu(), tref.ea_syrk(M, X, 0.95, False).cpu())
    assert torch.equal(got, ops.ea_syrk(M, X, 0.95, False))


@pytest.mark.cuda
@pytest.mark.parametrize("ld", [258, 257])
def test_cuda_ea_syrk_strides(cuda, ld):
    """X shared by the stack (batch stride 0) and a column slice of a
    wider matrix (rows 8- or 4-byte aligned), M a column slice too."""
    g = torch.Generator(device=cuda).manual_seed(8)
    X = torch.randn((300, ld), generator=g,
                    device=cuda)[:, :256].expand(3, 300, 256)
    M = torch.randn((3, 300, 310), generator=g, device=cuda)[..., :300]
    assert X.stride() == (0, ld, 1) and M.stride(1) == 310
    got = tea.ea_syrk_batched(M, X, 0.95, 0.05)
    _close(got.cpu(), (0.95 * M + 0.05 * X @ X.mT).cpu())
    assert torch.equal(got, tea.ea_syrk_batched(M, X, 0.95, 0.05))


#: (batch, d, n, layout of A) of syrk_tn: fc0's A⊥ (more splits than one
#: cluster), a Brand bucket, the RSVD range finder's (2, 256, 240) panel;
#: "slice": the [..., :n] column slice of a wider matrix (8- or 4-byte
#: aligned rows); "shared": one matrix for the stack (batch stride 0)
SYRK_CASES = [(1, 16384, 256, "contig"), (4, 512, 256, "contig"),
              (2, 256, 240, "contig"), (2, 700, 240, "slice"),
              (2, 130, 33, "slice"), (3, 1000, 100, "shared")]


@pytest.mark.cuda
@pytest.mark.parametrize("batch,d,n,layout", SYRK_CASES)
def test_cuda_syrk_tn(cuda, batch, d, n, layout):
    """syrk_tn (3xTF32, AᵀA over the stored rows, one triangle): against
    the plain version, one launch a call, the same bits on a second
    launch."""
    g = torch.Generator(device=cuda).manual_seed(9)
    if layout == "slice":
        A = torch.randn((batch, d, n + 10 if n > 100 else n + 2),
                        generator=g, device=cuda)[..., :n]
    elif layout == "shared":
        A = torch.randn((d, n), generator=g, device=cuda).expand(batch, d, n)
    else:
        A = torch.randn((batch, d, n), generator=g, device=cuda)
    _build.reset_launch_counts()
    got = tcq.syrk_tn_batched(A)
    assert _build.launch_counts()["syrk_tn"] == 1
    _close(got.cpu(), tref.syrk_tn(A).cpu())
    assert torch.equal(got, tcq.syrk_tn_batched(A))
    splits, cluster = _build._tc_plan_cached(n, n, d, batch, True,
                                             A.device.index)
    if d == 16384:          # the workspace path: 5 clusters of 8 a tile
        assert splits > cluster


#: (d, r, n, batch, layout of U).  "contig": a (batch, d, r) tensor (r = 230:
#: row stride 920 bytes, 8-byte aligned); "slice486": the [..., :r] column
#: slice of a (batch, d, 486) state, as the Brand update passes it;
#: "shared": one (d, r) matrix for the whole stack (batch stride 0).
BRAND_CASES = [
    (512, 230, 256, 4, "contig"), (27, 23, 16, 2, "contig"),
    # every Brand bucket of the paper VGG's light step, and fc0
    (512, 230, 256, 4, "slice486"), (576, 230, 256, 2, "slice486"),
    (1152, 230, 256, 2, "slice486"), (2048, 230, 256, 2, "slice486"),
    (2304, 230, 256, 2, "slice486"), (4608, 230, 256, 3, "slice486"),
    (16384, 230, 256, 1, "slice486"), (16384, 230, 256, 1, "contig"),
    (700, 33, 45, 3, "shared"), (2048, 230, 256, 2, "shared"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("d,r,n,batch,layout", BRAND_CASES)
def test_cuda_brand_panel_and_cholqr2(cuda, d, r, n, batch, layout):
    g = torch.Generator(device=cuda).manual_seed(1)
    # row-major Q (linalg.qr returns it column-major, which ops._flat would
    # copy to contiguous rows, hiding the strides under test)
    qr = lambda *s: torch.linalg.qr(torch.randn(s, generator=g,
                                                device=cuda))[0].contiguous()
    if layout == "slice486":
        U = qr(batch, d, 486)[..., :r]
    elif layout == "shared":
        U = qr(d, r).expand(batch, d, r)
    else:
        U = qr(batch, d, r)
    A = torch.randn((batch, d, n), generator=g, device=cuda)
    assert U.stride(-1) == 1 and U.stride(-2) == {"slice486": 486}.get(
        layout, r) and U.stride(0) == (0 if layout == "shared" else
                                       U.stride(-2) * d)
    got = ops.brand_panel(U, A)
    for a, b in zip(got, tref.brand_panel(U, A)):
        _close(a.cpu(), b.cpu())
    # ut_a sums its split-K partials in a fixed order: same bits each run
    assert torch.equal(got[0], ops.brand_panel(U, A)[0])
    Q, R = ops.cholqr2(A)
    _close((Q @ R).cpu(), A.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("d,r,n,batch,layout", BRAND_CASES)
def test_cuda_a_perp(cuda, d, r, n, batch, layout):
    """a_perp alone (the 3xTF32 tensor-core mainloop) at every U layout of
    BRAND_CASES, ragged K = r = 230 and 23 included: against the plain
    version, the same bits on a second launch, one launch a call."""
    g = torch.Generator(device=cuda).manual_seed(7)
    qr = lambda *s: torch.linalg.qr(torch.randn(s, generator=g,
                                                device=cuda))[0].contiguous()
    if layout == "slice486":
        U = qr(batch, d, 486)[..., :r]
    elif layout == "shared":
        U = qr(d, r).expand(batch, d, r)
    else:
        U = qr(batch, d, r)
    A = torch.randn((batch, d, n), generator=g, device=cuda)
    C = tref.ut_a(U, A).contiguous()
    _build.reset_launch_counts()
    got = tbp.a_perp_batched(A, U, C)
    assert _build.launch_counts()["a_perp"] == 1
    _close(got.cpu(), tref.a_perp(A, U, C).cpu())
    assert torch.equal(got, tbp.a_perp_batched(A, U, C))


@pytest.mark.cuda
def test_cuda_cholqr2_rsvd_panel(cuda):
    """cholqr2 at the RSVD range finder's (2, 256, 240) panel: a Gaussian
    256×240 block is ill-conditioned enough that the clamped spectral root
    engages, so Q R does not reproduce A; the kernels are held to the plain
    version on the same card instead."""
    g = torch.Generator(device=cuda).manual_seed(6)
    A = torch.randn((2, 256, 240), generator=g, device=cuda)
    _build.reset_launch_counts()
    got = ops.cholqr2(A)
    assert _build.launch_counts()["rinv_apply"] == 2
    for a, b in zip(got, tref.cholqr2(A)):
        _close(a.cpu(), b.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("p,d,wg,wa", [(2048, 10, 486, 10), (27, 64, 27, 64)])
def test_cuda_precond_fused(cuda, p, d, wg, wa):
    g = torch.Generator(device=cuda).manual_seed(2)
    r = lambda *s: torch.randn(s, generator=g, device=cuda)
    J = r(1, p, d)
    Ug = torch.linalg.qr(r(1, p, wg))[0]
    Ua = torch.linalg.qr(r(1, d, wa))[0]
    sg, sa = -r(1, wg).abs(), -r(1, wa).abs()
    _close(ops.precond_fused(J, Ug, sg, 2.0, Ua, sa, 3.0).cpu(),
           tref.precond_fused(J, Ug, sg, 2.0, Ua, sa, 3.0).cpu())


@pytest.mark.cuda
def test_cuda_launch_counts_and_shared_stack(cuda):
    """Each op launches its kernels exactly once per call, and a U shared
    across the stack (batch stride 0) gives the per-element result."""
    g = torch.Generator(device=cuda).manual_seed(3)
    U = torch.linalg.qr(torch.randn((64, 8), generator=g, device=cuda))[0]
    A = torch.randn((3, 64, 5), generator=g, device=cuda)
    _build.reset_launch_counts()
    C, P = ops.brand_panel(U, A)             # U broadcast over the stack
    counts = _build.launch_counts()
    assert counts["ut_a"] == 1 and counts["a_perp"] == 1
    for a, b in zip((C, P), tref.brand_panel(U.expand(3, 64, 8), A)):
        _close(a.cpu(), b.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(128, 128), (3, 128, 128),
                                   (2, 2, 200, 200), (96, 96), (2, 10, 10),
                                   (2, 2304, 2304)])
def test_cuda_ns_step(cuda, shape):
    """Both launches of a Newton–Schulz step (the shapes of
    tests/test_ns_inverse.py, plus d = 10 and NS-KFAC's largest bucket on
    the paper VGG) on the 3xTF32 tensor-core mainloop; the reference's
    tolerance there, atol 1e-3, rtol 1e-4; the same bits on a second
    step."""
    g = torch.Generator(device=cuda).manual_seed(4)
    A = torch.randn(shape, generator=g, device=cuda)
    M = A @ A.mT / shape[-1]
    X = 0.1 * torch.randn(shape, generator=g, device=cuda)
    _build.reset_launch_counts()
    got = ops.ns_step(M, X)
    assert _build.launch_counts()["ns_gemm_update"] == 2
    _close(got.cpu(), tref.ns_step(M, X).cpu(), atol=1e-3, rtol=1e-4)
    assert torch.equal(got, ops.ns_step(M, X))


@pytest.mark.cuda
@pytest.mark.parametrize("stack,p,d,w", [((), 256, 4608, 486),
                                         ((3,), 20, 10, 10),
                                         ((2,), 300, 700, 33)])
def test_cuda_lowrank_apply(cuda, stack, p, d, w):
    g = torch.Generator(device=cuda).manual_seed(5)
    r = lambda *s: torch.randn(s, generator=g, device=cuda)
    X = r(*stack, p, d)
    U = torch.linalg.qr(r(*stack, d, w))[0]
    s = -r(*stack, w).abs()
    lam = 0.5 + r(*stack).abs() if stack else 0.7
    _build.reset_launch_counts()
    got = ops.lowrank_apply(X, U, s, lam)
    assert _build.launch_counts()["lowrank_apply"] == 1
    _close(got.cpu(), tref.lowrank_apply(X, U, s, lam).cpu())
    # the left application's transposed operand (copied to rows by _flat)
    Xt = r(*stack, d, p).mT
    _close(ops.lowrank_apply(Xt, U, s, lam).cpu(),
           tref.lowrank_apply(Xt, U, s, lam).cpu())
