"""One ``Kfac.update`` sequence per paper variant on the kernel route
(``use_kernels=True``: Brand panel + CholeskyQR2 and the fused
preconditioning through ``kernels/ops.py``, their plain versions on the
CPU), held against the JAX package's ``Kfac.update`` with
``use_kernels=True`` (its oracles on the CPU).  The check itself is
``test_torch_kfac.check_update_sequence``.
"""
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from test_torch_kfac import (PAPER_VARIANTS, check_update_sequence,  # noqa: E402,E501
                             reference_grads)  # noqa: F401 (fixture)


@pytest.mark.parametrize("variant", PAPER_VARIANTS)
def test_kfac_update_kernel_route_matches_reference(variant,
                                                    reference_grads):
    check_update_sequence(variant, True, reference_grads)
