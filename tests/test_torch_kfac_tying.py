"""Weight-tying exactness of the port's KFAC and EKFAC.

The port's twins of ``tests/test_kfac_tying.py``, in float64 against the
port's dense block-diagonal GGN (1e-10): one weight ``W [in, out]`` applied
by ``x @ W`` to both halves of the input (two function-level dense uses of
one parameter, the JAX package's way of tying), one datum, MSE, type-2,
EXPAND: the tied paths are independent, so (E)KFAC is exact. A bias on one
use only is exact under separate and joint treatment (joint pads the bias
column with 1 / 0 per use); two distinct biases on one tied weight are
refused under joint treatment and exact under separate treatment.
"""

import numpy as np
import pytest
import torch
from torch import nn

from curvlinops_tpu_torch.kfac.ekfac import EKFACLinearOperator
from curvlinops_tpu_torch.kfac.operator import KFACLinearOperator
from curvlinops_tpu_torch.losses import MSELoss
from tests.test_torch_helpers import blockdiag_ggn, capped_torch_threads, rel_fro

_threads = capped_torch_threads()

D = 4
RTOL = 1e-10


class Tied(nn.Module):
    """``W`` applied to both input halves; ``biases`` names the bias added to
    each use (``None``: no bias), as ``tests/test_kfac_tying.py``'s
    ``split_concat_fn``, ``mixed_bias_fn`` and ``conflicting_bias_fn``."""

    def __init__(self, W: np.ndarray, b: np.ndarray, biases: tuple):
        super().__init__()
        self.W = nn.Parameter(torch.from_numpy(W))
        self.biases = biases
        for name in sorted({n for n in biases if n is not None}):
            sign = -1.0 if name == "b2" else 1.0  # the JAX test's b2 = -b
            setattr(self, name, nn.Parameter(torch.from_numpy(sign * b)))

    def forward(self, x):  # noqa: D102
        halves = []
        for x_half, bias in zip(x.chunk(2, dim=-1), self.biases):
            h = x_half @ self.W
            halves.append(h if bias is None else h + getattr(self, bias))
        return torch.cat(halves, dim=-1)


def _one_datum(seed: int):
    rng = np.random.default_rng(seed)
    X, y = rng.standard_normal((1, 2 * D)), rng.standard_normal((1, 2 * D))
    W, b = rng.standard_normal((D, D)) / np.sqrt(D), 0.1 * rng.standard_normal(D)
    return [(torch.from_numpy(X), torch.from_numpy(y))], W, b


def _assert_exact(cls, model, data, reduction, separate):
    params = dict(model.named_parameters())
    op = cls(model, MSELoss(reduction), params, data, fisher_type="type-2",
             kfac_approx="expand", separate_weight_and_bias=separate)
    expected = blockdiag_ggn(model, MSELoss(reduction), params, data, op.groups)
    err = rel_fro(op.todense(), expected)
    assert err < RTOL, f"relative error {err}"
    return op


@pytest.mark.parametrize("cls", [KFACLinearOperator, EKFACLinearOperator], ids=["kfac", "ekfac"])
@pytest.mark.parametrize("separate", [True, False], ids=["separate", "joint"])
@pytest.mark.parametrize("bias", [False, True], ids=["no_bias", "with_bias"])
@pytest.mark.parametrize("reduction", ["mean", "sum"])
def test_tying_type2_exact(cls, reduction, bias, separate):
    """Tied-weight (E)KFAC-expand equals the block-diagonal GGN for one datum."""
    data, W, b = _one_datum(0)
    model = Tied(W, b, ("b", "b") if bias else (None, None))
    op = _assert_exact(cls, model, data, reduction, separate)
    assert [len(g.uses) for g in op.groups if g.weight_path == "W"] == [2]


@pytest.mark.parametrize("cls", [KFACLinearOperator, EKFACLinearOperator], ids=["kfac", "ekfac"])
@pytest.mark.parametrize("separate", [True, False], ids=["separate", "joint"])
@pytest.mark.parametrize("reduction", ["mean", "sum"])
def test_mixed_bias_tying_type2_exact(cls, reduction, separate):
    """Tied ``W`` with a bias on its first use only."""
    data, W, b = _one_datum(1)
    _assert_exact(cls, Tied(W, b, ("b", None)), data, reduction, separate)


@pytest.mark.parametrize("reduction", ["mean", "sum"])
def test_conflicting_biases_joint_refused(reduction):
    """Joint treatment cannot merge two distinct biases on a tied weight."""
    data, W, b = _one_datum(2)
    model = Tied(W, b, ("b1", "b2"))
    with pytest.raises(ValueError, match="conflicting biases"):
        KFACLinearOperator(model, MSELoss(reduction), dict(model.named_parameters()), data,
                           fisher_type="type-2", separate_weight_and_bias=False)


@pytest.mark.parametrize("reduction", ["mean", "sum"])
def test_conflicting_biases_separate_ok(reduction):
    """Separate treatment handles distinct biases on a tied weight exactly."""
    data, W, b = _one_datum(3)
    _assert_exact(KFACLinearOperator, Tied(W, b, ("b1", "b2")), data, reduction, True)
