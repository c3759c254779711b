"""The 3xTF32 arithmetic of the tensor-core mainloop (``csrc/tc_gemm.cuh``,
under ``ns_gemm_update``, ``a_perp``, ``ea_syrk`` and ``syrk_tn``),
emulated on the CPU, and the split picker that sizes its launches.

The kernel runs only on the card (``tests/test_torch_cuda.py`` and
``chip_smoke.py`` hold it to its plain version there).  Its arithmetic is
emulated here, in the test and not in the package, as the kernel does it:
each fp32 value is rounded to tf32 through its bit pattern
(``view(torch.int32)``: add half a tf32 ulp, clear the 13 low mantissa
bits — round to nearest, ties away), big = tf32(x) and small =
tf32(x − big); each 32-deep k-step sums A_b·B_s + A_s·B_b first and
A_b·B_b after (the 3xTF32 split; where the whole K fits one k-step, the
fourth product A_s·B_s first of all), into a fresh fp32 partial that is
then added to the running fp32 sum.  The products of tf32 values are
exact in fp32, as in the tensor core.

What the emulation shows:
- the error of the split against a float64 product stays within 4× that
  of an fp32 matmul (the bound ``chip_smoke.py`` holds the kernel to
  against cuBLAS) at the shapes of the ``kernels`` phase — with fewer rows
  and columns where the CPU time needs it, K kept;
- NS-KFAC's refresh takes the same decisions (warm or cold start, the
  residual check, the LU repair) and reaches the same inverses on the
  small VGG's NS factors when its ``ns_step`` runs through the emulation;
- the symmetric products as the ``SYM`` launches compute them (only the
  128-tiles on or above the diagonal, each off-diagonal one stored again
  at the mirrored place with its own addend, K split and summed as the
  plan says) stay within the same 4× at every path shape, and
  CholeskyQR2 with its Gram passes through them keeps the plain
  version's clamped-root decisions and orthonormality.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import kfactor  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

#: the kernel's largest error against float64 may be at most this many
#: times the plain fp32 version's (chip_smoke.py's bound on the card)
RATIO = 4.0


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The emulation is many small products: on one intra-op thread they
    cost the same alone and do not crawl when parallel test workers share
    the cores (each worker's thread pool spans all of them)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """Round fp32 to the nearest tf32 value (ties away from zero) by its
    bit pattern, as the kernel does."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def tf32x3_matmul(A: torch.Tensor, B: torch.Tensor,
                  bk: int = _build.TC_BK, small_small=None) -> torch.Tensor:
    """A @ B as the kernel computes it (fp32 in, fp32 out): the fourth
    product A_s·B_s only where K fits one k-step (``small_small``: where
    the whole contraction of which A @ B is one split does)."""
    Ab, Bb = tf32(A), tf32(B)
    As, Bs = tf32(A - Ab), tf32(B - Bb)
    acc = torch.zeros(A.shape[:-1] + B.shape[-1:], dtype=torch.float32)
    if small_small is None:
        small_small = A.shape[-1] <= bk
    for k0 in range(0, A.shape[-1], bk):
        k = slice(k0, k0 + bk)
        part = Ab[..., k] @ Bs[..., k, :] + As[..., k] @ Bb[..., k, :]
        if small_small:
            part = As[..., k] @ Bs[..., k, :] + part
        acc = acc + (part + Ab[..., k] @ Bb[..., k, :])
    return acc


def tf32x3_gemm_update(C, A, B, alpha, beta):
    """``ref.gemm_update`` with the product emulated."""
    AB = beta * tf32x3_matmul(A, B)
    return AB if alpha == 0 else alpha * C + AB


def tf32x3_ns_step(Mhat, X):
    """``ref.ns_step`` as the two kernel launches compute it."""
    T = tf32x3_gemm_update(None, Mhat, X, 0.0, 1.0)
    return tf32x3_gemm_update(X, X, T, 2.0, -1.0)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32))


def test_tf32_split_is_exact_in_tf32_and_22_bits_deep():
    rng = np.random.default_rng(0)
    x = _t(rng.standard_normal(100_000) * 10.0 ** rng.integers(-20, 20,
                                                               100_000))
    big = tf32(x)
    small = tf32(x - big)
    for part in (big, small):             # the hardware reads them as they are
        assert not bool((part.view(torch.int32) & 0x1FFF).any())
    # round to nearest: within half a tf32 ulp of x, and big + small within
    # 2^-22 of x (relative), where truncation leaves 2^-10 and 2^-20
    rel = lambda y: ((y.double() - x.double()).abs() / x.double().abs())
    assert float(rel(big).max()) <= 2.0 ** -11
    assert float(rel(big.double() + small.double()).max()) <= 2.0 ** -22
    trunc = (x.view(torch.int32) & -0x2000).view(torch.float32)
    assert float(rel(trunc).max()) > 2.0 ** -11


#: ns_gemm_update at every (B, d) of the paper VGG's NS-KFAC path (both
#: launches: T = M̂X and X' = 2X − XT), and a_perp at fc0 and every Brand
#: bucket.  (rows, K, cols) cut to at most 512 × K × 512 (K kept).
NS_SHAPES = [(1, 10), (1, 27), (2, 64), (2, 128), (2, 256), (4, 512),
             (2, 576), (2, 1152), (2, 2048), (2, 2304)]
BRAND = [(1, 16384), (4, 512), (2, 576), (2, 1152), (2, 2048), (2, 2304),
         (3, 4608)]


def _ns_operands(b, d, launch):
    rng = np.random.default_rng(d)
    G = rng.standard_normal((b, d, d))
    Mh = (G @ G.transpose(0, 2, 1) / d).astype(np.float32)
    X = (0.1 * rng.standard_normal((b, d, d))).astype(np.float32)
    keep = min(d, 512)
    if launch == "T":                       # T = M̂ X
        return None, _t(Mh[:, :keep]), _t(X[..., :keep]), 0.0, 1.0
    T = _t(Mh) @ _t(X)                      # X' = 2X − X T
    return (_t(X[:, :keep, :keep]), _t(X[:, :keep]),
            T[..., :keep].contiguous(), 2.0, -1.0)


def _errors(got32, exact, plain32):
    return (float((got32.double() - exact).abs().max()),
            float((plain32.double() - exact).abs().max()))


@pytest.mark.parametrize("launch", ["T", "X'"])
@pytest.mark.parametrize("b,d", NS_SHAPES)
def test_tf32x3_ns_gemm_update_error_within_ratio(b, d, launch):
    C, A, B, alpha, beta = _ns_operands(b, d, launch)
    exact = beta * (A.double() @ B.double())
    if alpha:
        exact = exact + alpha * C.double()
    emu, plain = _errors(tf32x3_gemm_update(C, A, B, alpha, beta), exact,
                         tref.gemm_update(C, A, B, alpha, beta))
    assert emu <= RATIO * plain, (emu, plain)


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
# the symmetric products: ea_syrk (X Xᵀ) and syrk_tn (AᵀA)
# ---------------------------------------------------------------------------

def tf32x3_split(A, B, splits, cluster):
    """A @ B as a launch split ``splits`` ways over K in clusters of
    ``cluster`` sums it: each split's k-steps from zero, the splits of a
    cluster added in rank order, then the clusters' sums in order."""
    K = A.shape[-1]
    kchunk = -(-(-(-K // splits)) // _build.TC_BK) * _build.TC_BK
    parts = []
    for s in range(splits):
        k = slice(min(K, s * kchunk), min(K, (s + 1) * kchunk))
        parts.append(tf32x3_matmul(A[..., k], B[..., k, :],
                                   small_small=K <= _build.TC_BK))
    total = None
    for g in range(0, splits, cluster):
        acc = parts[g]
        for r in range(1, cluster):
            acc = acc + parts[g + r]
        total = acc if total is None else total + acc
    return total


def tf32x3_syrk(opA, opB, plan, alpha=1.0, beta=0.0, addend=None):
    """alpha · opA opB + beta · addend as the SYM kernel stores it:
    opA (B, d, K) and opB (B, K, d) give a symmetric product; only the
    128-tiles on or above the diagonal are computed (split as ``plan``
    says), each off-diagonal one stored again, transposed, at the mirrored
    place, every entry through the epilogue with its own addend entry."""
    d = opA.shape[-2]
    T = _build.TC_TILE
    out = torch.empty(opA.shape[:-2] + (d, d), dtype=torch.float32)

    def epi(P, i, j):
        v = alpha * P
        return v if addend is None else v + beta * addend[..., i, j]
    for t0 in range(0, d, T):
        for u0 in range(t0, d, T):
            i, j = slice(t0, t0 + T), slice(u0, u0 + T)
            P = tf32x3_split(opA[..., i, :], opB[..., :, j], *plan)
            out[..., i, j] = epi(P, i, j)
            if u0 != t0:
                out[..., j, i] = epi(P.mT, j, i)
    return out


#: ea_syrk at every dense bucket of the paper VGG's paths, (stack, d): the
#: five of B-KFAC (d ≤ 256), then NS-KFAC's larger ones; X (B, d, 256)
EA_BUCKETS = [(1, 10), (1, 27), (2, 64), (2, 128), (2, 256), (4, 512),
              (2, 576), (2, 1152), (2, 2048), (2, 2304)]
#: syrk_tn at every Brand bucket of a B-KFAC light step, A⊥ (B, d, 256),
#: and the RSVD range finder's (2, 256, 240) panel: (stack, d, n)
SYRK_PANELS = [(1, 16384, 256), (3, 4608, 256), (2, 2304, 256),
               (2, 2048, 256), (2, 1152, 256), (2, 576, 256), (4, 512, 256),
               (2, 256, 240)]


def _plan(M, K, batch):
    return _build.tc_plan(M, M, K, batch, H100_TC_RESIDENT.__getitem__,
                          sym=True)


@pytest.mark.parametrize("b,d", EA_BUCKETS)
def test_tf32x3_ea_syrk_error_within_ratio(b, d):
    """keep·M + coef·X Xᵀ through the emulated SYM/BT launch (the plan of
    the real shape; rows cut to 384, K = 256 kept), M not symmetric."""
    rng = np.random.default_rng(100 + d)
    rows = min(d, 384)
    M = _t(rng.standard_normal((b, rows, rows)))
    X = _t(rng.standard_normal((b, rows, 256)))
    keep = np.float32(0.95)
    coef = np.float32(1.0) - keep
    emu = tf32x3_syrk(X, X.mT, _plan(d, 256, b), float(coef), float(keep),
                      M)
    exact = (float(keep) * M.double()
             + float(coef) * (X.double() @ X.double().mT))
    e, p = _errors(emu, exact, tref.ea_syrk(M, X, 0.95, False))
    assert e <= RATIO * p, (e, p)


def _a_perp_panel(b, d, n, rng, dependent=0):
    """A⊥ = A − U UᵀA of a Brand update (U orthonormal, r = 230), or for
    d < 486 a Gaussian panel; its last ``dependent`` columns are
    combinations of the others, so the clamped root has work to do."""
    A = rng.standard_normal((b, d, n))
    if dependent:
        A[..., n - dependent:] = (A[..., :n - dependent]
                                  @ rng.standard_normal((n - dependent,
                                                         dependent)) / 16)
    if d >= 486:
        U = np.linalg.qr(rng.standard_normal((b, d, 230)))[0]
        A = A - U @ (U.transpose(0, 2, 1) @ A)
    return _t(A)


@pytest.mark.parametrize("b,d,n", SYRK_PANELS)
def test_tf32x3_syrk_tn_error_within_ratio(b, d, n):
    """AᵀA through the emulated SYM/AT launch at every panel of the path,
    K = d kept (fc0's 16384: 40 splits in 5 clusters of 8)."""
    A = _a_perp_panel(b, d, n, np.random.default_rng(200 + d))
    emu = tf32x3_syrk(A.mT, A, _plan(n, d, b))
    e, p = _errors(emu, A.double().mT @ A.double(), tref.syrk_tn(A))
    assert e <= RATIO * p, (e, p)


def _cholqr2(A, syrk):
    """``ref.cholqr2`` with its Gram pass taken by ``syrk``; returns Q and
    both passes' clamp decisions (the eigenvalues kept)."""
    R1, B1, keep1 = _root(syrk(A), tref.CHOLQR_FLOOR_RESOLVE, "tr")
    Q0 = tref.rinv_apply(A, B1)
    R2, B2, keep2 = _root(syrk(Q0), tref.CHOLQR_FLOOR_REFINE, "max")
    return tref.rinv_apply(Q0, B2), (keep1, keep2)


def _root(G, floor_rel, mode):
    vals = tref.eigh(G)[0]
    scale = (torch.diagonal(G, dim1=-2, dim2=-1).sum(-1) if mode == "tr"
             else vals[..., -1])
    R, Bm = tref.gram_inv_sqrt(G, floor_rel, mode)
    return R, Bm, vals > floor_rel * scale[..., None] + 1e-30


@pytest.mark.parametrize("dependent", [0, 16])
@pytest.mark.parametrize("b,d,n", SYRK_PANELS[1:])
def test_cholqr2_same_decisions_under_tf32x3_syrk_tn(b, d, n, dependent):
    """CholeskyQR2 with its Gram passes through the emulated syrk_tn keeps
    the same eigenvalues in both clamped roots as the plain version, and
    its Q is as orthonormal: the eigenvalues of QᵀQ (those of ‖QᵀQ − I‖
    over the kept directions, 0 over the dropped ones) within 2× the plain
    version's distance, both under 1e-5 (fp32 rounding of a 256-wide
    Gram).  With ``dependent`` columns the first root must drop them.
    (fc0's panel is held to float64 above; here it would double the
    file's time.)"""
    A = _a_perp_panel(b, d, n, np.random.default_rng(300 + d),
                      dependent=dependent)
    plan = _plan(n, d, b)
    Qe, keep_e = _cholqr2(A, lambda X: tf32x3_syrk(X.mT, X, plan))
    Qp, keep_p = _cholqr2(A, tref.syrk_tn)
    for ke, kp in zip(keep_e, keep_p):
        assert torch.equal(ke, kp)
    assert int(keep_p[0].sum(-1).max()) <= n - dependent
    kept = keep_p[1].sum(-1)

    def orth(Q):   # largest distance of QᵀQ's spectrum from 1 (kept) or 0
        ev = torch.linalg.eigvalsh((Q.mT @ Q).double())
        want = (torch.arange(n) >= n - kept[..., None]).double()
        return float((ev - want).abs().max())
    assert orth(Qe) <= max(2 * orth(Qp), 1e-6), (orth(Qe), orth(Qp))
    assert orth(Qe) < 1e-5 and orth(Qp) < 1e-5


# ---------------------------------------------------------------------------
# NS-KFAC's decisions on the small VGG's NS factors
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def small_vgg_ns_factors():
    """(spec, state) of every NS factor of the small VGG (the preset of
    tests/test_torch_nskfac.py, max_dense_dim 512) after 5 NS-KFAC steps
    on the CPU: M holds 5 steps of statistics, U the step-0 inverse."""
    from repro_torch.core import kfac as tkfac
    from repro_torch.core import policy as tpolicy
    from repro_torch.data.synthetic import ImageStream
    from repro_torch.models.cnn import VggConfig, make_vgg
    from repro_torch.optim import base as tbase
    from repro_torch.train import loop as tloop

    cpu = torch.device("cpu")
    model, taps = make_vgg(VggConfig(stages=(16, 32, 64), fc_hidden=512,
                                     n_stat=64), device=cpu, seed=0)
    opt = tkfac.Kfac(tkfac.KfacConfig(
        policy=tpolicy.PolicyConfig(variant="nskfac", r=96,
                                    max_dense_dim=512),
        lr=tbase.constant(0.03), clip=0.1,
        fallback_lr=tbase.constant(1e-3), damping_phi=tbase.constant(0.1),
        spectrum_continuation=False, use_kernels=True, T_updt=2, T_brand=2,
        T_inv=5, T_rsvd=5, T_corct=5), taps, device=cpu)
    stream = ImageStream(batch=16, seed=0, device=cpu)
    state, _ = tloop.run_kfac_training(
        model.loss, opt, model.params(), [stream.batch_at(i)
                                          for i in range(5)],
        n_tokens=16, seed=0, device=cpu)
    out = []
    for name in sorted(opt.taps):
        for side in "AG":
            spec = opt.specs[name][side]
            if spec.mode is kfactor.Mode.NS:
                out.append((f"{name}.{side}", spec,
                            getattr(state.opt.factors[name], side)))
    assert len(out) >= 8
    return out


def test_nskfac_refresh_same_decisions_under_tf32x3(small_vgg_ns_factors,
                                                    monkeypatch):
    plain = {k: kfactor.ns_overwrite(spec, st)
             for k, spec, st in small_vgg_ns_factors}
    monkeypatch.setattr(ops, "ns_step", tf32x3_ns_step)
    for key, spec, st in small_vgg_ns_factors:
        emu = kfactor.ns_overwrite(spec, st)
        want = plain[key]
        res_e = emu.aux[..., kfactor.AUX_RES]
        res_p = want.aux[..., kfactor.AUX_RES]
        # the same residual check (and so the same LU repairs) slot by slot
        assert torch.equal(res_e < kfactor._NS_RES_MAX,
                           res_p < kfactor._NS_RES_MAX), key
        assert torch.equal(emu.aux[..., kfactor.AUX_LAM],
                           want.aux[..., kfactor.AUX_LAM]), key
        # the same inverse, to fp32 rounding over 8 Hotelling steps
        scale = float(want.U.abs().max())
        assert float((emu.U - want.U).abs().max()) <= 1e-4 * scale, key
        # residuals agree far inside the 0.5 of the check (converged ones
        # are fp32 rounding, ~1e-6, in both)
        assert bool(((res_e - res_p).abs()
                     <= 1e-4 + 1e-3 * res_p.abs()).all()), key


# ---------------------------------------------------------------------------
# the split picker
# ---------------------------------------------------------------------------

#: Blocks of the tensor-core GEMM an H100 SXM holds at once in clusters of
#: c, one block an SM (cudaOccupancyMaxActiveClusters × c; chip_smoke.py
#: prints them).  A cluster sits within one GPC, so clusters of 3 or more
#: reach fewer SMs.
H100_TC_RESIDENT = {1: 132, 2: 132, 3: 117, 4: 120, 5: 110, 6: 102, 7: 105,
                    8: 120}


#: ns_gemm_update at every NS bucket of the paper VGG (M = N = K = d) and
#: a_perp at every Brand bucket (M = d, N = 256, K = r = 230) → splits
@pytest.mark.parametrize("M,N,K,batch,want", [
    (10, 10, 10, 1, 1),              # one k-step: nothing to split
    (27, 27, 27, 1, 1),
    (64, 64, 64, 2, 1),              # 2 k-steps: a cluster costs more
    (128, 128, 128, 2, 4),
    (256, 256, 256, 2, 8),           # 8 tiles → 64 blocks of one k-step
    (512, 512, 512, 4, 2),
    (576, 576, 576, 2, 2),
    (1152, 1152, 1152, 2, 2),        # 162 tiles: 1.2 waves unsplit
    (2048, 2048, 2048, 2, 1),
    (2304, 2304, 2304, 2, 1),        # 648 tiles, 4.9 waves
    (16384, 256, 230, 1, 1),         # a_perp at fc0: 256 tiles
    (4608, 256, 230, 3, 1),
    (2304, 256, 230, 2, 1),
    (2048, 256, 230, 2, 2),
    (1152, 256, 230, 2, 3),
    (576, 256, 230, 2, 4),
    (512, 256, 230, 4, 3),
])
def test_tc_split_choice(M, N, K, batch, want):
    resident = H100_TC_RESIDENT.__getitem__
    s = _build.tc_split(M, N, K, batch, resident)
    assert s == want
    assert 1 <= s <= _build.TC_MAX_SPLIT
    # no split empty; a split launch fits the card at once or needs fewer
    # waves × k-steps than the unsplit one
    kchunk = -(-(-(-K // s)) // _build.TC_BK) * _build.TC_BK
    assert (s - 1) * kchunk < K
    tiles = _build.tc_tiles(M, N) * batch
    if s > 1:
        unsplit = -(-tiles // resident(1)) * -(-K // _build.TC_BK)
        split = -(-tiles * s // resident(s)) * (kchunk // _build.TC_BK)
        assert split < unsplit


#: the symmetric products (one triangle of 128-tiles) → (splits, cluster):
#: syrk_tn at every CholeskyQR2 panel of the path (M = N = n, K = d) and
#: ea_syrk at every dense bucket (M = N = d, K = n = 256)
@pytest.mark.parametrize("M,K,batch,want", [
    # fc0's Gram: 3 tiles; 5 clusters of 8 a tile fill 120 SMs at once,
    # 13 k-steps a block (one cluster a tile: 24 blocks of 64 k-steps)
    (256, 16384, 1, (40, 8)),
    (256, 4608, 3, (12, 4)),
    (256, 2304, 2, (15, 5)),
    (256, 2048, 2, (16, 8)),
    (256, 1152, 2, (12, 6)),
    (256, 576, 2, (6, 6)),
    (256, 512, 4, (8, 8)),
    (240, 256, 2, (8, 8)),           # the RSVD range finder's panel
    (10, 256, 1, (8, 8)),            # ea_syrk: one tile, 8 k-steps
    (27, 256, 1, (8, 8)),
    (64, 256, 2, (8, 8)),
    (128, 256, 2, (8, 8)),
    (256, 256, 2, (8, 8)),
    (512, 256, 4, (2, 2)),           # 40 triangle tiles
    (576, 256, 2, (4, 4)),
    (1152, 256, 2, (1, 1)),          # 90 tiles: one wave unsplit
    (2048, 256, 2, (1, 1)),
    (2304, 256, 2, (1, 1)),          # 342 tiles, 2.6 waves
])
def test_tc_plan_sym_choice(M, K, batch, want):
    resident = H100_TC_RESIDENT.__getitem__
    splits, cluster = _build.tc_plan(M, M, K, batch, resident, sym=True)
    assert (splits, cluster) == want
    assert splits % cluster == 0 and 1 <= cluster <= _build.TC_MAX_SPLIT
    assert splits == 1 or cluster >= 2
    # no split empty
    kchunk = -(-(-(-K // splits)) // _build.TC_BK) * _build.TC_BK
    assert (splits - 1) * kchunk < K
    tiles = _build.tc_tiles(M, M, sym=True) * batch
    assert tiles == batch * (-(-M // 128)) * (-(-M // 128) + 1) // 2
    if splits > cluster:
        # past one cluster only where one of 8 a tile leaves SMs idle, and
        # then every block resident at once
        assert tiles * _build.TC_MAX_SPLIT < resident(_build.TC_MAX_SPLIT)
        assert tiles * splits <= resident(cluster)
