"""The 3xTF32 arithmetic of the tensor-core mainloop (``csrc/tc_gemm.cuh``,
under ``ns_gemm_update`` and ``a_perp``), emulated on the CPU, and the
split picker that sizes its launches.

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
  small VGG's NS factors when its ``ns_step`` runs through the emulation.
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


def tf32(x: torch.Tensor) -> torch.Tensor:
    """Round fp32 to the nearest tf32 value (ties away from zero) by its
    bit pattern, as the kernel does."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def tf32x3_matmul(A: torch.Tensor, B: torch.Tensor,
                  bk: int = _build.TC_BK) -> torch.Tensor:
    """A @ B as the kernel computes it (fp32 in, fp32 out): the fourth
    product A_s·B_s only where K fits one k-step."""
    Ab, Bb = tf32(A), tf32(B)
    As, Bs = tf32(A - Ab), tf32(B - Bb)
    acc = torch.zeros(A.shape[:-1] + B.shape[-1:], dtype=torch.float32)
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
