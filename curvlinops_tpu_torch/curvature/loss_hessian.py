"""Closed-form loss-Hessian structure: square roots and grad-output samplers.

PyTorch counterpart of ``curvlinops_tpu/curvature/loss_hessian.py``. For each
supported loss the Hessian w.r.t. the prediction of ONE datum factorizes as
``S S^T``; this module provides

- ``loss_hessian_sqrt_columns``: the columns of ``S`` (type-2 Fisher),
- ``sample_grad_outputs``: Monte-Carlo vectors ``g`` with ``E[g g^T] = S S^T``,
- ``empirical_grad_output``: the per-datum loss gradient (empirical Fisher),
- ``make_grad_output_fn``: the dispatcher the KFAC computer uses.

Where the JAX functions act on one datum and are ``vmap``-ed, these act on a
batch ``[N, *datum]`` and return ``[N, V, *datum]``. Randomness comes from an
explicit ``torch.Generator`` (the JAX package threads ``jax.random`` keys);
the two give different draws from the same seed, so tests compare sample
statistics, not samples.

With ``reduction='mean'`` a datum's loss also averages over its non-class
entries, contributing the constant ``c = 1/num_features``; the batch average
is applied by the caller.
"""

from __future__ import annotations

import math
from enum import Enum
from typing import Callable

import torch
import torch.nn.functional as F

from curvlinops_tpu_torch.losses import BCEWithLogitsLoss, CrossEntropyLoss, MSELoss


class FisherType(str, Enum):
    """Which curvature proxy the grad-output vectors realize."""

    TYPE2 = "type-2"
    MC = "mc"
    EMPIRICAL = "empirical"
    FORWARD_ONLY = "forward-only"


class KFACType(str, Enum):
    """Weight-sharing treatment in KFAC."""

    EXPAND = "expand"
    REDUCE = "reduce"


def mean_rescale(loss_fn, y: torch.Tensor):
    """``static_terms / non_ignored_count`` for mean-reduced CE, else 1.

    The closed-form grad outputs count one loss term per target entry, while
    the CE mean divides by the non-ignored count; this linear factor converts
    a batch's contribution to the masked-loss convention (exactly 1 when no
    target is ignored). Returned as a tensor on ``y``'s device, so no host
    synchronisation happens.
    """
    if not (isinstance(loss_fn, CrossEntropyLoss) and loss_fn.reduction == "mean"):
        return 1.0
    total = float(y.numel()) if y.ndim else 1.0
    count = (y != loss_fn.ignore_index).sum().clamp(min=1)
    return total / count.to(torch.float32)


def _feature_constant(loss_fn, datum_shape: tuple) -> float:
    """Per-datum reduction constant ``c`` (1 for sum, 1/num_features for mean)."""
    n = math.prod(datum_shape)
    num_features = n // datum_shape[0] if isinstance(loss_fn, CrossEntropyLoss) else n
    return {"sum": 1.0, "mean": 1.0 / num_features}[loss_fn.reduction]


def loss_hessian_sqrt_columns(
    loss_fn, output: torch.Tensor, target: torch.Tensor
) -> torch.Tensor:
    r"""Columns of ``S`` with ``S S^T = \nabla^2_f loss(f, y)`` for each datum.

    Args:
        loss_fn: MSE / CE / BCE loss.
        output: Predictions ``[N, *datum]``; ``datum = [C, *D]`` for CE.
        target: Targets ``[N, ...]``.

    Returns:
        ``[N, V, *datum]`` with ``V = prod(datum)``: the type-2 grad outputs.
    """
    N, shape = output.shape[0], tuple(output.shape[1:])
    n = math.prod(shape)
    c = _feature_constant(loss_fn, shape)

    if isinstance(loss_fn, MSELoss):
        cols = math.sqrt(2 * c) * torch.eye(n, dtype=output.dtype, device=output.device)
        return cols.reshape(1, n, *shape).expand(N, n, *shape)

    if isinstance(loss_fn, BCEWithLogitsLoss):
        p = torch.sigmoid(output.reshape(N, n))
        cols = torch.diag_embed(math.sqrt(c) * torch.sqrt(p * (1 - p)))
        return cols.reshape(N, n, *shape)

    if isinstance(loss_fn, CrossEntropyLoss):
        C = shape[0]
        D = n // C
        p = torch.softmax(output.reshape(N, C, D), dim=1).transpose(1, 2)  # [N, D, C]
        p_sqrt = p.sqrt()
        # S_t[c, v] = sqrt(c0) (delta_cv sqrt(p_v) - sqrt(p_v) p_c)
        S = math.sqrt(c) * (
            torch.diag_embed(p_sqrt) - p[..., :, None] * p_sqrt[..., None, :]
        )  # [N, D, C_row, C_col]
        # ignored positions have a zero loss Hessian
        mask = (target != loss_fn.ignore_index).reshape(N, D)
        S = S * mask[:, :, None, None].to(output.dtype)
        # column (v, s) has support only at position s
        eye_D = torch.eye(D, dtype=output.dtype, device=output.device)
        cols = torch.einsum("ntcv,ts->nvsct", S, eye_D)  # [N, C, D, C, D]
        return cols.reshape(N, n, *shape)

    raise NotImplementedError(f"Loss {type(loss_fn).__name__} not supported.")


def sample_grad_outputs(
    loss_fn,
    output: torch.Tensor,
    target: torch.Tensor,
    generator: torch.Generator,
    num_samples: int,
) -> torch.Tensor:
    r"""Draw MC grad outputs with ``E[g g^T] = \nabla^2_f loss`` per datum.

    Returns:
        ``[N, num_samples, *datum]`` (not yet scaled by ``1/sqrt(M)``).
    """
    N, shape = output.shape[0], tuple(output.shape[1:])
    c = _feature_constant(loss_fn, shape)
    M = num_samples

    if isinstance(loss_fn, MSELoss):
        noise = torch.randn(
            (N, M, *shape), generator=generator, dtype=output.dtype, device=output.device
        )
        return math.sqrt(2 * c) * noise

    if isinstance(loss_fn, BCEWithLogitsLoss):
        p = torch.sigmoid(output)[:, None].expand(N, M, *shape)
        draws = torch.bernoulli(p, generator=generator)
        return math.sqrt(c) * (p - draws)

    if isinstance(loss_fn, CrossEntropyLoss):
        C = shape[0]
        D = math.prod(shape) // C
        p = torch.softmax(output.reshape(N, C, D), dim=1).transpose(1, 2)  # [N, D, C]
        draws = torch.multinomial(
            p.reshape(N * D, C), M, replacement=True, generator=generator
        ).reshape(N, D, M)
        onehot = F.one_hot(draws, C).to(output.dtype)  # [N, D, M, C]
        g = math.sqrt(c) * (p[:, :, None, :] - onehot)
        mask = (target != loss_fn.ignore_index).reshape(N, D)
        g = g * mask[:, :, None, None].to(output.dtype)
        return g.permute(0, 2, 3, 1).reshape(N, M, *shape)

    raise NotImplementedError(f"Loss {type(loss_fn).__name__} not supported.")


def empirical_grad_output(
    loss_fn, output: torch.Tensor, target: torch.Tensor
) -> torch.Tensor:
    r"""Per-datum loss gradient for the empirical Fisher.

    For mean-reduced MSE/BCE the single-datum loss carries an extra feature
    average; it is rescaled by ``sqrt(num_features)`` so that the outer
    product contributes ``g g^T / num_features`` as the EF requires.

    Returns:
        ``[N, 1, *datum]``.
    """
    n = math.prod(output.shape[1:])
    scale = 1.0
    if isinstance(loss_fn, (MSELoss, BCEWithLogitsLoss)) and loss_fn.reduction == "mean":
        scale = math.sqrt(n)

    def datum_loss(f, y):
        return loss_fn(f[None], y[None])

    g = torch.func.vmap(torch.func.grad(datum_loss))(output, target)
    return (scale * g)[:, None]


def make_grad_output_fn(
    loss_fn, fisher_type: FisherType, mc_samples: int = 1
) -> Callable[[torch.Tensor, torch.Tensor, torch.Generator], torch.Tensor]:
    """Batched grad-output dispatcher.

    Returns:
        ``(output [N, *datum], target, generator) -> [N, V, *datum]`` with
        ``V = prod(datum)`` (type-2), ``mc_samples`` (MC, scaled by
        ``1/sqrt(M)``), ``1`` (empirical) or ``0`` (forward-only).
    """
    fisher_type = FisherType(fisher_type)
    if fisher_type == FisherType.TYPE2:
        return lambda out, y, gen: loss_hessian_sqrt_columns(loss_fn, out, y)
    if fisher_type == FisherType.MC:
        scale = 1.0 / math.sqrt(mc_samples)
        return lambda out, y, gen: scale * sample_grad_outputs(
            loss_fn, out, y, gen, mc_samples
        )
    if fisher_type == FisherType.EMPIRICAL:
        return lambda out, y, gen: empirical_grad_output(loss_fn, out, y)
    return lambda out, y, gen: out.new_zeros((out.shape[0], 0, *out.shape[1:]))
