"""Generalized Gauss-Newton (and Monte-Carlo Fisher) linear operator.

PyTorch counterpart of ``curvlinops_tpu/curvature/ggn.py``. Per batch and
column ``v`` the exact GGN-vector product is

1. ``torch.func.jvp`` of the model: ``v -> J v``;
2. ``torch.func.jvp`` of the loss gradient w.r.t. the prediction:
   ``J v -> H_loss J v``;
3. the pullback of one ``torch.func.vjp`` of the model:
   ``H_loss J v -> J^T H_loss J v``.

The vjp's forward pass runs once per batch, and its residuals serve every
column; the jvp is mapped over the columns (:func:`vmap_columns`), so its
primal forward also runs once, with the tangents batched. The JAX package
linearizes instead (``jax.linearize`` + ``jax.linear_transpose``, one
forward); ``torch.func.linearize`` evaluates the model twice as well and
adds an FX trace and constant folding on every call, so two plain forwards
are the cheaper route here.

With ``mc_samples > 0`` the loss Hessian is replaced by ``sum_k g_k g_k^T``
with sampled grad-output vectors (MC Fisher). The samples come from the
per-batch generator (:func:`~curvlinops_tpu_torch.risk.batch_generator`),
so repeated and chained matvecs see the same samples.

Example:
    >>> import torch
    >>> from torch import nn
    >>> from curvlinops_tpu_torch import GGNLinearOperator, HessianLinearOperator
    >>> from curvlinops_tpu_torch.losses import MSELoss
    >>> gen = torch.Generator().manual_seed(0)
    >>> model = nn.Linear(5, 3, bias=False)
    >>> X, y = torch.rand((8, 5), generator=gen), torch.rand((8, 3), generator=gen)
    >>> args = (model, MSELoss("mean"), dict(model.named_parameters()), [(X, y)])
    >>> G, H = GGNLinearOperator(*args), HessianLinearOperator(*args)
    >>> v = torch.randn(15, generator=gen)
    >>> # for a LINEAR model the GGN equals the Hessian
    >>> bool(torch.allclose(G @ v, H @ v, atol=1e-5))
    True
    >>> # MC Fisher: sampled grad-outputs, deterministic across matvecs
    >>> F = GGNLinearOperator(*args, mc_samples=8, seed=0, check_deterministic=False)
    >>> bool(torch.allclose(F @ v, F @ v))
    True
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from curvlinops_tpu_torch.curvature.loss_hessian import (
    FisherType,
    make_grad_output_fn,
    mean_rescale,
)
from curvlinops_tpu_torch.risk import CurvatureLinearOperator
from curvlinops_tpu_torch.utils.flatten import tree_scale, vmap_columns


def make_batch_ggn_matmat(
    model_fn: Callable, loss_fn: Callable, max_vmap_columns: int | None = None
) -> Callable:
    """Build the per-batch exact-GGN matmat ``(params, X, y, M, c, gen) -> c G M``."""

    def batch_matmat(params: Any, X: Any, y: Any, M: Any, c: float, generator) -> Any:
        del generator

        def f(p):
            return model_fn(p, X)

        pred, vjp_fn = torch.func.vjp(f, params)
        loss_grad = torch.func.grad(lambda q: loss_fn(q, y))

        def ggnvp(v: Any) -> Any:
            _, jv = torch.func.jvp(f, (params,), (v,))
            _, hjv = torch.func.jvp(loss_grad, (pred,), (jv,))
            return vjp_fn(hjv)[0]

        return tree_scale(c, vmap_columns(ggnvp, M, max_vmap_columns))

    return batch_matmat


def make_batch_ggn_mc_matmat(
    model_fn: Callable,
    loss_fn: Callable,
    mc_samples: int,
    max_vmap_columns: int | None = None,
) -> Callable:
    """Build the per-batch MC-Fisher matmat.

    Implements ``J^T (sum_{n,k} g_nk g_nk^T / c_batch) J v`` with sampled
    grad-output vectors ``g`` (already ``1/sqrt(mc_samples)``-scaled), the
    middle factor applied as two einsums.
    """
    grad_output_fn = make_grad_output_fn(loss_fn, FisherType.MC, mc_samples)

    def batch_matmat(params: Any, X: Any, y: Any, M: Any, c: float, generator) -> Any:
        def f(p):
            return model_fn(p, X)

        pred, vjp_fn = torch.func.vjp(f, params)
        # [N, V, *out] sampled grad outputs
        G = grad_output_fn(pred.detach(), y, generator)
        # the batch reduction of a mean loss; mean_rescale turns the static
        # loss-term count into the CE ignore_index denominator (1 unpadded)
        c_batch = float(pred.shape[0]) if loss_fn.reduction == "mean" else 1.0
        c_batch = c_batch / mean_rescale(loss_fn, y)

        def fishervp(v: Any) -> Any:
            _, jv = torch.func.jvp(f, (params,), (v,))
            coeff = torch.einsum("nk...,n...->nk", G, jv.to(G.dtype))
            tangent = torch.einsum("nk...,nk->n...", G, coeff) / c_batch
            return vjp_fn(tangent.to(jv.dtype))[0]

        return tree_scale(c, vmap_columns(fishervp, M, max_vmap_columns))

    return batch_matmat


class GGNLinearOperator(CurvatureLinearOperator):
    r"""Matrix-free GGN ``c sum_n J_n^T (nabla^2_f ell) J_n`` of the empirical risk.

    Args:
        mc_samples: ``0`` (default) for the exact GGN; ``> 0`` replaces the
            loss Hessian by a Monte-Carlo estimate from that many sampled
            grad-output vectors per datum (MC Fisher).

    All other arguments as :class:`curvlinops_tpu_torch.risk.EmpiricalRiskOperator`.
    """

    SELF_ADJOINT = True

    def __init__(self, model, loss_fn, params, data, *, mc_samples: int = 0, **kw):
        self._mc_samples = mc_samples
        if mc_samples > 0:
            # per-batch MC samples must replay identically across matvecs
            self.FIXED_DATA_ORDER = True
            self.USES_RANDOMNESS = True
        super().__init__(model, loss_fn, params, data, **kw)

    def _make_batch_matmat(self) -> Callable:
        if self._mc_samples > 0:
            return make_batch_ggn_mc_matmat(
                self._model_fn, self._loss_fn, self._mc_samples, self._max_vmap_columns
            )
        return make_batch_ggn_matmat(self._model_fn, self._loss_fn, self._max_vmap_columns)
