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


@pytest.mark.cuda
@pytest.mark.parametrize("d,n,batch", [(27, 256, 1), (256, 256, 2),
                                       (10, 33, 3)])
def test_cuda_ea_syrk(cuda, d, n, batch):
    g = torch.Generator(device=cuda).manual_seed(0)
    M = torch.randn((batch, d, d), generator=g, device=cuda)
    X = torch.randn((batch, d, n), generator=g, device=cuda)
    _close(ops.ea_syrk(M, X, 0.95, False).cpu(),
           tref.ea_syrk(M, X, 0.95, False).cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("d,r,n,batch", [(512, 230, 256, 4), (27, 23, 16, 2)])
def test_cuda_brand_panel_and_cholqr2(cuda, d, r, n, batch):
    g = torch.Generator(device=cuda).manual_seed(1)
    U = torch.linalg.qr(torch.randn((batch, d, r), generator=g,
                                    device=cuda))[0]
    A = torch.randn((batch, d, n), generator=g, device=cuda)
    for a, b in zip(ops.brand_panel(U, A), tref.brand_panel(U, A)):
        _close(a.cpu(), b.cpu())
    Q, R = ops.cholqr2(A)
    _close((Q @ R).cpu(), A.cpu())


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
