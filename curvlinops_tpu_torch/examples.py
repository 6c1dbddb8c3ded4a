"""Dense ground-truth builders for checking the matrix-free operators.

PyTorch counterpart of ``curvlinops_tpu/examples.py``: autodiff-built dense
curvature matrices of the concatenated dataset (``torch.func.jacrev`` and
``torch.func.hessian``), on the parameters flattened in their tree's leaf
order (the operators' flat order). Small models only: each builds a
``[P, P]`` matrix.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
from torch.utils import _pytree as pytree

from curvlinops_tpu_torch.curvature.ef import flatten_prediction, flatten_target
from curvlinops_tpu_torch.losses import BCEWithLogitsLoss, CrossEntropyLoss
from curvlinops_tpu_torch.risk import default_batch_size
from curvlinops_tpu_torch.utils.flatten import ravel_tree
from curvlinops_tpu_torch.utils.misc import as_model_fn


def total_loss_fn(model, loss_fn: Callable, data, batch_size_fn=None) -> Callable:
    """Build ``params -> empirical risk`` with the operators' normalization."""
    model_fn = as_model_fn(model)
    batch_size_fn = batch_size_fn or default_batch_size
    N = sum(batch_size_fn(X) for X, _ in data)

    def total_loss(params):
        acc = 0.0
        for X, y in data:
            c = batch_size_fn(X) / N if loss_fn.reduction == "mean" else 1.0
            acc = acc + c * loss_fn(model_fn(params, X), y)
        return acc

    return total_loss


def gradient_and_loss(
    model, loss_fn: Callable, params: Any, data, batch_size_fn=None
) -> tuple[Any, torch.Tensor]:
    """Gradient tree and loss of the empirical risk."""
    total = total_loss_fn(model, loss_fn, data, batch_size_fn)
    params = pytree.tree_map(lambda t: t.detach(), params)
    return torch.func.grad_and_value(total)(params)


def dense_hessian(model, loss_fn, params, data, batch_size_fn=None) -> torch.Tensor:
    """Dense Hessian of the empirical risk w.r.t. the flattened parameters."""
    flat, unravel = ravel_tree(pytree.tree_map(lambda t: t.detach(), params))
    total = total_loss_fn(model, loss_fn, data, batch_size_fn)
    return torch.func.hessian(lambda v: total(unravel(v)))(flat)


def dense_ggn(model, loss_fn, params, data, batch_size_fn=None) -> torch.Tensor:
    """Dense generalized Gauss-Newton: per-batch ``J^T H_loss J``, summed."""
    model_fn = as_model_fn(model)
    batch_size_fn = batch_size_fn or default_batch_size
    N = sum(batch_size_fn(X) for X, _ in data)
    flat, unravel = ravel_tree(pytree.tree_map(lambda t: t.detach(), params))
    G = torch.zeros((flat.numel(), flat.numel()), dtype=flat.dtype, device=flat.device)
    for X, y in data:
        c = batch_size_fn(X) / N if loss_fn.reduction == "mean" else 1.0
        pred = model_fn(unravel(flat), X)
        J = torch.func.jacrev(lambda v: model_fn(unravel(v), X).reshape(-1))(flat)
        Hl = torch.func.hessian(lambda pf: loss_fn(pf.reshape(pred.shape), y))(
            pred.detach().reshape(-1)
        )
        G += c * (J.T @ Hl @ J)
    return G


def dense_empirical_fisher(model, loss_fn, params, data, batch_size_fn=None) -> torch.Tensor:
    """Dense empirical Fisher: one gradient row per loss term (CE) or per
    summed feature group (MSE/BCE, rescaled by ``1/sqrt(C)`` under mean
    reduction); ``EF = J^T J / norm`` with ``norm`` the row count for mean."""
    model_fn = as_model_fn(model)
    flat, unravel = ravel_tree(pytree.tree_map(lambda t: t.detach(), params))
    Xs = [X for X, _ in data]
    X_all = pytree.tree_map(lambda *leaves: torch.cat(leaves), *Xs)
    y_rows = flatten_target(loss_fn, torch.cat([y for _, y in data]))

    def row_losses(v):
        rows = flatten_prediction(loss_fn, model_fn(unravel(v), X_all))
        if isinstance(loss_fn, CrossEntropyLoss):
            return -torch.log_softmax(rows, dim=-1).gather(-1, y_rows[:, None].long())[:, 0]
        if isinstance(loss_fn, BCEWithLogitsLoss):
            x = rows
            return (x.clamp(min=0) - x * y_rows + torch.log1p(torch.exp(-x.abs()))).sum(-1)
        return ((rows - y_rows) ** 2).sum(-1)

    J = torch.func.jacrev(row_losses)(flat)
    L = J.shape[0]
    if loss_fn.reduction == "mean" and not isinstance(loss_fn, CrossEntropyLoss):
        C = flatten_prediction(loss_fn, model_fn(unravel(flat), X_all)).shape[-1]
        J = J / C**0.5
    norm = float(L) if loss_fn.reduction == "mean" else 1.0
    return J.T @ J / norm


def dense_jacobian(model, params, data) -> torch.Tensor:
    """Dense Jacobian of the concatenated flattened predictions w.r.t. the
    flattened parameters."""
    model_fn = as_model_fn(model)
    flat, unravel = ravel_tree(pytree.tree_map(lambda t: t.detach(), params))
    return torch.cat([
        torch.func.jacrev(lambda v, X=X: model_fn(unravel(v), X).reshape(-1))(flat)
        for X, _ in data
    ])
