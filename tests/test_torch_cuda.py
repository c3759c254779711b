"""The CUDA kernels against their plain versions, on the card.

Every test here is marked ``cuda`` and skips on a host without a card
(the kernels have no CPU mode).  The file imports no JAX, so it also runs
on the H100 machine, which has none:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerance: fp32 in and out with another summation order than cuBLAS,
atol = rtol = 2e-3 (the reference's fp32 kernel-parity tolerance); bf16
in and out, atol = rtol = 5e-2 (tests/test_kernels.py's bf16 tolerance).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels import brand_panel as tbp  # noqa: E402
from repro_torch.kernels import cholqr as tcq  # noqa: E402
from repro_torch.kernels import ea_syrk as tea  # noqa: E402
from repro_torch.kernels import lowrank_apply as tla  # noqa: E402
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


@pytest.mark.cuda
@pytest.mark.parametrize("batch,d,n,rb", [(2, 512, 16, 256), (1, 300, 33, 150),
                                          (3, 2560, 16, 1280)])
def test_cuda_ea_syrk_row_block(cuda, batch, d, n, rb):
    """ea_syrk's row-block form (a rank's rows [r0, r0+rb) of M, X whole:
    keep·M_rows + coef·X_rows Xᵀ, unmirrored) at each block: against the
    plain version, one launch a call, the same bits on a second launch."""
    g = torch.Generator(device=cuda).manual_seed(9)
    X = torch.randn((batch, d, n), generator=g, device=cuda)
    for r0 in range(0, d, rb):
        M = torch.randn((batch, rb, d), generator=g, device=cuda)
        Xr = X[:, r0:r0 + rb]
        _build.reset_launch_counts()
        got = ops.ea_syrk(M, X, 0.95, False, Xr)
        assert _build.launch_counts()["ea_syrk"] == 1
        _close(got.cpu(), tref.ea_syrk(M, X, 0.95, False, Xr).cpu())
        assert torch.equal(got, ops.ea_syrk(M, X, 0.95, False, Xr))


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


#: (stack, p, d, w_g, w_a, layout of U_a) of precond_fused: an fc0-like
#: bucket with its rows cut (the panel split over a cluster, the three
#: apply launches at w = 486: U rows 1944 bytes apart), the ragged fc1 and
#: conv0_0 buckets (d = 10; p = w_g = 27, K ≤ 32), and a stack whose U_a
#: is one matrix for all (batch stride 0) with per-element λ
PRECOND_CASES = [((1,), 2048, 2048, 486, 486, "own"),
                 ((1,), 2048, 10, 486, 10, "own"),
                 ((1,), 27, 64, 27, 64, "own"),
                 ((3,), 300, 70, 33, 50, "shared")]


@pytest.mark.cuda
@pytest.mark.parametrize("stack,p,d,wg,wa,layout", PRECOND_CASES)
def test_cuda_precond_fused(cuda, stack, p, d, wg, wa, layout):
    """Both passes (four 3xTF32 products) against the plain version: one
    panel and one apply launch per call, the same bits on a second call."""
    g = torch.Generator(device=cuda).manual_seed(2)
    r = lambda *s: torch.randn(s, generator=g, device=cuda)
    qr = lambda *s: torch.linalg.qr(r(*s))[0].contiguous()
    J = r(*stack, p, d)
    Ug = qr(*stack, p, wg)
    Ua = (qr(d, wa).expand(*stack, d, wa) if layout == "shared"
          else qr(*stack, d, wa))
    sg, sa = -r(*stack, wg).abs(), -r(*stack, wa).abs()
    lam_g = 2.0 if layout == "own" else 1.0 + r(*stack).abs()
    _build.reset_launch_counts()
    got = ops.precond_fused(J, Ug, sg, lam_g, Ua, sa, 3.0)
    counts = _build.launch_counts()
    assert counts["precond_panel"] == 1 and counts["precond_apply"] == 1
    _close(got.cpu(), tref.precond_fused(J, Ug, sg, lam_g, Ua, sa,
                                         3.0).cpu())
    assert torch.equal(got, ops.precond_fused(J, Ug, sg, lam_g, Ua, sa, 3.0))
    if p == 2048 and d == 2048:   # the panel splits p over one cluster
        splits, cluster = _build._tc_plan_cached(wg, d, p, 1, False,
                                                 J.device.index)
        assert splits == cluster > 1


def _bf16_case(op, g, dev):
    """(args, kernels launched) of one op at the reference's bf16 shapes
    (tests/test_kernels.py) or near them, every array bf16."""
    r = lambda *s: torch.randn(s, generator=g, device=dev)
    qr = lambda *s: torch.linalg.qr(r(*s))[0]
    bf = lambda *xs: [x.to(torch.bfloat16) for x in xs]
    if op == "ea_syrk":
        M = r(384, 384)
        return bf((M + M.mT) / 2, r(384, 128)) + [0.95, True], ["ea_syrk"]
    if op == "brand_panel":
        return bf(qr(256, 8), r(256, 128)), ["ut_a", "a_perp"]
    if op == "cholqr2":
        return bf(r(256, 64)), ["syrk_tn", "rinv_apply"]
    if op == "ns_step":
        A = r(128, 128)
        return bf(A @ A.mT / 128, 0.1 * r(128, 128)), ["ns_gemm_update"]
    if op.startswith("lowrank_apply"):   # X by rows, or by columns
        X = r(256, 384).mT if op.endswith(":columns") else r(384, 256)
        return (bf(X, qr(256, 8), -(0.1 + 0.9 * r(8).abs()))
                + [0.7], ["lowrank_apply"])
    J, Ug, Ua = bf(r(384, 256), qr(384, 64), qr(256, 8))
    sg, sa = bf(-r(64).abs(), -r(8).abs())
    return [J, Ug, sg, 2.0, Ua, sa, 3.0], ["precond_panel", "precond_apply"]


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["ea_syrk", "brand_panel", "cholqr2",
                                "ns_step", "lowrank_apply",
                                "lowrank_apply:columns", "precond_fused"])
def test_cuda_bf16(cuda, op):
    """bf16 operands through every kernel: the op launches its kernels
    (fp32 inside), returns the reference's dtypes (bf16; cholqr2's R fp32)
    and agrees with the plain version on the same bf16 inputs
    (lowrank_apply with X by rows and by columns)."""
    args, kernels = _bf16_case(op, torch.Generator(device=cuda).manual_seed(
        10), cuda)
    op = op.split(":")[0]
    _build.reset_launch_counts()
    got = getattr(ops, op)(*args)
    counts = _build.launch_counts()
    assert all(counts[k] >= 1 for k in kernels), counts
    want = getattr(tref, op)(*args)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        _close(a.float().cpu(), b.float().cpu(), atol=5e-2, rtol=5e-2)


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


#: (stack, p, d, w) of lowrank_apply: small ragged shapes, then the paths'
#: largest launches: NS-KFAC's fc0 (X 2048 × 16384, by columns on the
#: path) and conv4 bucket (stack 3), the Alg-8 fc0 A side (256 × 16384, by
#: rows); every case in both layouts
LOWRANK_CASES = [((), 256, 4608, 486), ((3,), 20, 10, 10),
                 ((2,), 300, 700, 33), ((), 2048, 16384, 486),
                 ((3,), 512, 4608, 486), ((), 256, 16384, 486)]


@pytest.mark.cuda
@pytest.mark.parametrize("stack,p,d,w", LOWRANK_CASES)
def test_cuda_lowrank_apply(cuda, monkeypatch, stack, p, d, w):
    """Both layouts of X — rows, and the left application's transposed
    view of a tensor with contiguous rows — against the plain version: one
    launch a call, the same bits on a second call; by columns, the kernel
    gets X where it lies and Y comes back as the transposed view of a
    contiguous (…, d, p), so neither is copied."""
    g = torch.Generator(device=cuda).manual_seed(5)
    r = lambda *s: torch.randn(s, generator=g, device=cuda)
    U = torch.linalg.qr(r(*stack, d, w))[0]
    s = -r(*stack, w).abs()
    lam = 0.5 + r(*stack).abs() if stack else 0.7
    handed = []
    wrapper = tla.lowrank_apply_batched

    def spy(X, *rest):
        handed.append(X)
        return wrapper(X, *rest)
    monkeypatch.setattr(tla, "lowrank_apply_batched", spy)
    for cols in (False, True):
        X = r(*stack, d, p).mT if cols else r(*stack, p, d)
        handed.clear()
        _build.reset_launch_counts()
        got = ops.lowrank_apply(X, U, s, lam)
        assert _build.launch_counts()["lowrank_apply"] == 1
        _close(got.cpu(), tref.lowrank_apply(X, U, s, lam).cpu())
        assert torch.equal(got, ops.lowrank_apply(X, U, s, lam))
        if cols:
            assert handed[0].data_ptr() == X.data_ptr()
            assert tla.columns(handed[0]) and got.mT.is_contiguous()


def _async_tiny_run(device, overlap):
    """B-R-KFAC on one 24×8 tap (A side BRAND_RSVD, G side EVD; r 4,
    T_rsvd 4, stagger, heavy_lag 2), 8 steps through the kernels, with or
    without the async runner → (losses, runner, side-stream launches)."""
    from repro_torch.core import kfac as tkfac
    from repro_torch.core import policy as tpolicy
    from repro_torch.models import layers as tlayers
    from repro_torch.optim import base as tbase
    from repro_torch.train import loop as tloop

    g = torch.Generator().manual_seed(0)
    w = torch.randn((24, 8), generator=g) * 0.1
    batches = [(torch.randn((8, 24), generator=g).to(device),
                torch.randn((8, 8), generator=g).to(device))
               for _ in range(8)]

    def loss_fn(p, probes, batch):
        x, y = batch
        h, act = tlayers.tapped_matmul(p["fc/w"], x, probes.get("fc"), 8)
        return torch.mean((h - y) ** 2), {"fc": act}

    cfg = tkfac.KfacConfig(
        policy=tpolicy.PolicyConfig(variant="brkfac", r=4),
        lr=tbase.constant(0.05), T_updt=1, T_brand=1, T_rsvd=4,
        stagger=True, async_heavy=True, heavy_lag=2, use_kernels=True)
    opt = tkfac.Kfac(cfg, {"fc": tkfac.TapInfo("fc/w", 24, 8, n_stat=8)},
                     device=device)
    runner = tloop.AsyncInverseRunner.for_opt(opt) if overlap else None
    _build.reset_launch_counts()
    _, losses = tloop.run_kfac_training(
        loss_fn, opt, {"fc/w": w.to(device).requires_grad_()}, batches,
        n_tokens=8, device=device, overlap=runner or False)
    torch.cuda.synchronize()
    return losses, runner, _build.side_launch_counts()


@pytest.mark.cuda
def test_cuda_async_runner_on_side_stream(cuda):
    """On the card the runner's heavy op runs on its side stream (the
    RSVD's CholeskyQR2 kernels are counted there), lands every range whose
    landing falls in the run with no miss, and gives the in-line landing's
    losses (rtol 1e-6 / atol 1e-7, the reference's overlapped-landing
    tolerance; the kernels are deterministic)."""
    inline, _, side0 = _async_tiny_run(cuda, overlap=False)
    over, runner, side = _async_tiny_run(cuda, overlap=True)
    assert not any(side0.values())
    assert side["syrk_tn"] > 0 and side["rinv_apply"] > 0, side
    assert runner.stream is not None
    h = runner.health
    assert h["missed"] == 0 and h["landed"] >= 1, h
    np.testing.assert_allclose(over, inline, rtol=1e-6, atol=1e-7)


@pytest.mark.cuda
def test_cuda_factorizations_give_nan_for_a_nonfinite_matrix(cuda):
    """cuSOLVER's eigh and SVD on a batch holding one NaN matrix: that
    element comes back NaN (the health guard then drops the step), the
    others as if alone — as on the CPU (test_torch_resilience.py)."""
    from repro_torch.core import brand as tbrand
    g = torch.Generator(device=cuda).manual_seed(0)
    A = torch.randn((3, 12, 12), generator=g, device=cuda)
    M = A @ A.mT
    M[1, 3, 2] = float("nan")   # eigh reads the lower triangle
    vals, vecs = tref.eigh(M)
    assert torch.isnan(vals[1]).all() and torch.isnan(vecs[1]).all()
    for i in (0, 2):
        v, U = tref.eigh(M[i:i + 1])
        torch.testing.assert_close(vals[i:i + 1], v)
        torch.testing.assert_close((vecs[i] * vals[i]) @ vecs[i].mT, M[i],
                                   atol=1e-4, rtol=1e-4)
    X = torch.randn((2, 12, 5), generator=g, device=cuda)
    X[0, 0, 0] = float("nan")
    U, D = tbrand.init_from_factor(X, 8)
    assert torch.isnan(D[0, :5]).all() and torch.isfinite(D[1]).all()
