"""Empirical Fisher (uncentered gradient covariance) linear operator.

PyTorch counterpart of ``curvlinops_tpu/curvature/ef.py``. With per-loss-term
predictions flattened to rows ``f_i`` (CE: ``[N, C, *d] -> [(N *d), C]``,
MSE/BCE: ``[N, *d, C] -> [(N *d), C]``) and unreduced row gradients
``g_i = nabla_{f_i} ell_i``, the batch EF is

    EF_batch = (1/R) J^T [ sum_i g_i g_i^T ] J,   R = L (CE) or L*C (MSE/BCE)

for mean reduction (``R`` = the non-ignored target count for CE with
``ignore_index``), ``R = 1`` for sum, where ``L`` is the number of loss
terms in the batch. The middle factor is applied with two einsums between a
``torch.func.jvp`` mapped over the columns and the pullback of one
``torch.func.vjp``. The KFAC computer uses the two flatten helpers.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from curvlinops_tpu_torch.losses import SUPPORTED_LOSSES, CrossEntropyLoss
from curvlinops_tpu_torch.risk import CurvatureLinearOperator
from curvlinops_tpu_torch.utils.flatten import tree_scale, vmap_columns


def flatten_prediction(loss_fn, pred: torch.Tensor) -> torch.Tensor:
    """Flatten extra dims into the row axis: ``-> [num_loss_terms, C]``."""
    if isinstance(loss_fn, CrossEntropyLoss):
        moved = pred.movedim(1, -1) if pred.ndim > 2 else pred
        return moved.reshape(-1, moved.shape[-1])
    if pred.ndim == 1:
        return pred[:, None]
    return pred.reshape(-1, pred.shape[-1])


def flatten_target(loss_fn, y: torch.Tensor) -> torch.Tensor:
    """Flatten targets to match :func:`flatten_prediction` rows."""
    if isinstance(loss_fn, CrossEntropyLoss):
        return y.reshape(-1)
    if y.ndim == 1:
        return y[:, None]
    return y.reshape(-1, y.shape[-1])


def make_row_grad(loss_fn) -> Callable:
    """Per-row loss gradient ``[L, C] x [L, ...] -> [L, C]`` (``vmap`` of ``grad``).

    Raises:
        NotImplementedError: For a loss outside MSE/CE/BCE.
    """
    if not isinstance(loss_fn, SUPPORTED_LOSSES):
        raise NotImplementedError(
            f"Loss must be one of {[c.__name__ for c in SUPPORTED_LOSSES]}, "
            f"got {type(loss_fn).__name__}."
        )
    summed = dataclasses.replace(loss_fn, reduction="sum")

    def row_loss(f_row: torch.Tensor, y_row: torch.Tensor) -> torch.Tensor:
        """Unreduced loss of one flattened row (sum over its C features)."""
        return summed(f_row[None], y_row[None])

    return torch.func.vmap(torch.func.grad(row_loss))


def make_batch_ef_matmat(
    model_fn: Callable, loss_fn, max_vmap_columns: int | None = None
) -> Callable:
    """Build the per-batch empirical-Fisher matmat ``(params, X, y, M, c, gen) -> c EF M``."""
    row_grad = make_row_grad(loss_fn)

    def batch_matmat(params: Any, X: Any, y: Any, M: Any, c: float, generator) -> Any:
        del generator

        def f_flat(p):
            return flatten_prediction(loss_fn, model_fn(p, X))

        y_flat = flatten_target(loss_fn, y)
        pred_flat, vjp_fn = torch.func.vjp(f_flat, params)
        G = row_grad(pred_flat.detach(), y_flat)  # [L, C] rows

        L, C = pred_flat.shape
        R = 1.0
        if loss_fn.reduction == "mean":
            if isinstance(loss_fn, CrossEntropyLoss):
                # the mean divides by the non-ignored loss-term count
                R = (y_flat != loss_fn.ignore_index).sum().clamp(min=1).to(pred_flat.dtype)
            else:
                R = float(L * C)

        def efvp(v: Any) -> Any:
            _, jv = torch.func.jvp(f_flat, (params,), (v,))
            coeff = torch.einsum("lc,lc->l", G, jv)
            return vjp_fn(coeff[:, None] * G / R)[0]

        return tree_scale(c, vmap_columns(efvp, M, max_vmap_columns))

    return batch_matmat


class EFLinearOperator(CurvatureLinearOperator):
    r"""Matrix-free empirical Fisher ``c sum_n g_n g_n^T`` of the empirical risk."""

    SELF_ADJOINT = True

    def _make_batch_matmat(self) -> Callable:
        return make_batch_ef_matmat(self._model_fn, self._loss_fn, self._max_vmap_columns)
