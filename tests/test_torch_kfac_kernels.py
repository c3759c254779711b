"""One ``Kfac.update`` sequence per variant on the kernel route
(``use_kernels=True``: Brand panel + CholeskyQR2, the fused
preconditioning, ``lowrank_apply`` and the Newton–Schulz step through
``kernels/ops.py``, their plain versions on the CPU), held against the
JAX package's ``Kfac.update`` with ``use_kernels=True`` (its oracles on
the CPU); nskfac and B-KFAC with Alg-8 linear-apply taps included.  The
check itself is ``test_torch_kfac.check_update_sequence``.
"""
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from test_torch_kfac import (ALL_VARIANTS, LINEAR,  # noqa: E402
                             check_update_sequence,
                             reference_grads)  # noqa: F401 (fixture)


@pytest.mark.parametrize("variant", ALL_VARIANTS)
def test_kfac_update_kernel_route_matches_reference(variant,
                                                    reference_grads):
    check_update_sequence(variant, True, reference_grads)


def test_kfac_update_linear_apply_kernel_route_matches_reference(
        reference_grads):
    check_update_sequence("bkfac", True, reference_grads, linear=LINEAR)
