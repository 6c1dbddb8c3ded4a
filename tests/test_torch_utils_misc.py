"""The port's worked examples and ``allclose_report``, on the CPU.

Twins of the doctests and ``test_allclose_report`` of
``tests/test_utils_misc.py``: the port modules whose JAX counterparts carry
worked examples (the Hessian, the GGN, KFAC, the Kronecker product and the
inverse operators) carry their own, in torch, and they run here; and
``allclose_report`` agrees with the JAX package's on the same numpy inputs
and prints the mismatching entries.
"""

from __future__ import annotations

import doctest
import importlib

import numpy as np
import pytest

from curvlinops_tpu.utils.misc import allclose_report as jax_allclose_report
from curvlinops_tpu_torch.utils.misc import allclose_report
from tests.test_torch_helpers import capped_torch_threads

_threads = capped_torch_threads()


@pytest.mark.parametrize(
    "module_name",
    [
        "curvlinops_tpu_torch.curvature.hessian",
        "curvlinops_tpu_torch.curvature.ggn",
        "curvlinops_tpu_torch.kfac.operator",
        "curvlinops_tpu_torch.ops.kronecker",
        "curvlinops_tpu_torch.ops.inverse",
    ],
)
def test_doctests(module_name):
    """Each module's worked example runs and holds."""
    results = doctest.testmod(importlib.import_module(module_name), verbose=False)
    assert results.attempted > 0, f"no worked example in {module_name}"
    assert results.failed == 0, f"{results.failed} doctest failures in {module_name}"


def test_allclose_report(capsys):
    """Close and not close as the JAX package says, and the first mismatch
    printed with its index."""
    a, b = np.ones(3), np.asarray([1.0, 2.0, 1.0])
    assert allclose_report(np.ones(3), np.ones(3)) is jax_allclose_report(np.ones(3), np.ones(3))
    assert not allclose_report(a, b) and not jax_allclose_report(a, b)
    out = capsys.readouterr().out
    assert out.count("mismatch at (1,)") == 2
