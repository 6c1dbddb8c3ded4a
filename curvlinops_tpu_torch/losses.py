"""Loss functions with the structure curvature operators need.

PyTorch counterpart of ``curvlinops_tpu/losses.py``: small frozen dataclasses
that are callables ``(prediction, target) -> scalar`` with torch's numerics
and expose a ``reduction`` the curvature code reads. Closed-form Hessian
structure (square roots, grad-output samplers) lives in
:mod:`curvlinops_tpu_torch.curvature.loss_hessian`.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F


@dataclass(frozen=True)
class Loss:
    """Base class: a reduction-aware scalar loss ``(pred, y) -> scalar``."""

    reduction: str = "mean"

    def __post_init__(self):  # noqa: D105
        if self.reduction not in ("mean", "sum"):
            raise ValueError(f"Unsupported reduction {self.reduction!r}.")

    def _reduce(self, elementwise: torch.Tensor) -> torch.Tensor:
        return elementwise.mean() if self.reduction == "mean" else elementwise.sum()


@dataclass(frozen=True)
class MSELoss(Loss):
    """Squared error, reduced over all elements (``nn.MSELoss``)."""

    def __call__(self, prediction: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        return self._reduce((prediction - target) ** 2)


@dataclass(frozen=True)
class CrossEntropyLoss(Loss):
    """Softmax cross-entropy on logits ``[N, C, *dims]`` (``nn.CrossEntropyLoss``).

    Targets are class indices ``[N, *dims]``. Targets equal to
    ``ignore_index`` contribute zero loss, and ``mean`` divides by the number
    of non-ignored targets (at least one).
    """

    ignore_index: int = -100

    def __call__(self, prediction: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        logits = prediction
        if logits.ndim > 2:
            logits = logits.movedim(1, -1).reshape(-1, logits.shape[1])
            target = target.reshape(-1)
        mask = target != self.ignore_index
        safe_t = torch.where(mask, target, torch.zeros_like(target)).long()
        nll = -F.log_softmax(logits, dim=-1).gather(-1, safe_t[:, None])[:, 0]
        nll = torch.where(mask, nll, torch.zeros_like(nll))
        if self.reduction == "mean":
            return nll.sum() / mask.sum().clamp(min=1)
        return nll.sum()


@dataclass(frozen=True)
class BCEWithLogitsLoss(Loss):
    """Elementwise sigmoid binary cross-entropy (``nn.BCEWithLogitsLoss``)."""

    def __call__(self, prediction: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        x, y = prediction, target
        elementwise = x.clamp(min=0) - x * y + torch.log1p(torch.exp(-x.abs()))
        return self._reduce(elementwise)


SUPPORTED_LOSSES = (MSELoss, CrossEntropyLoss, BCEWithLogitsLoss)
