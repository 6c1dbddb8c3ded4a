"""Hessian of the empirical risk as a matrix-free linear operator.

PyTorch counterpart of ``curvlinops_tpu/curvature/hessian.py``. The
per-batch kernel is the forward-over-reverse Hessian-vector product,
``torch.func.jvp`` of ``torch.func.grad`` of the batch loss, mapped over
the matmat's columns (:func:`vmap_columns`): the primal forward and
backward run once per batch, the tangents batched over the columns.

Example:
    >>> import torch
    >>> from torch import nn
    >>> from curvlinops_tpu_torch import HessianLinearOperator
    >>> from curvlinops_tpu_torch.losses import MSELoss
    >>> gen = torch.Generator().manual_seed(0)
    >>> D_in, D_out, N = 4, 2, 10
    >>> model = nn.Linear(D_in, D_out, bias=False)
    >>> X = torch.rand((N, D_in), generator=gen)
    >>> y = torch.rand((N, D_out), generator=gen)
    >>> data = [(X[:5], y[:5]), (X[5:], y[5:])]
    >>> H = HessianLinearOperator(
    ...     model, MSELoss(reduction="sum"), dict(model.named_parameters()), data
    ... )
    >>> # analytic Hessian of sum-MSE for a linear model: 2 I_Dout (x) X^T X
    >>> H_mat = 2 * torch.kron(torch.eye(D_out), X.T @ X)
    >>> v = torch.randn(D_in * D_out, generator=gen)
    >>> bool(torch.allclose(H_mat @ v, H @ v, atol=1e-5))
    True
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from curvlinops_tpu_torch.risk import CurvatureLinearOperator
from curvlinops_tpu_torch.utils.flatten import tree_scale, vmap_columns


def make_batch_hessian_matmat(
    model_fn: Callable, loss_fn: Callable, max_vmap_columns: int | None = None
) -> Callable:
    """Build the per-batch Hessian matmat ``(params, X, y, M, c, gen) -> c H M``."""

    def batch_matmat(params: Any, X: Any, y: Any, M: Any, c: float, generator) -> Any:
        del generator
        loss_grad = torch.func.grad(lambda p: loss_fn(model_fn(p, X), y))

        def hvp(v: Any) -> Any:
            return torch.func.jvp(loss_grad, (params,), (v,))[1]

        return tree_scale(c, vmap_columns(hvp, M, max_vmap_columns))

    return batch_matmat


class HessianLinearOperator(CurvatureLinearOperator):
    r"""Matrix-free Hessian :math:`\nabla^2_\theta \mathcal{L}` of the empirical risk."""

    SELF_ADJOINT = True

    def _make_batch_matmat(self) -> Callable:
        return make_batch_hessian_matmat(self._model_fn, self._loss_fn, self._max_vmap_columns)
