"""Dataset statistics shared by the curvature operators.

PyTorch counterpart of the two helpers in ``curvlinops_tpu/risk.py`` that
the KFAC computer needs. ``EmpiricalRiskOperator`` and
``CurvatureLinearOperator`` come with the GGN-vector-product slice.
"""

from __future__ import annotations

import math
from typing import Any

import torch

from curvlinops_tpu_torch.losses import CrossEntropyLoss, Loss


def default_batch_size(X: Any) -> int:
    """Leading dimension of ``X`` (a tensor, or the first tensor of a dict/sequence)."""
    if isinstance(X, torch.Tensor):
        return int(X.shape[0])
    leaves = list(X.values()) if isinstance(X, dict) else list(X)
    if not leaves:
        raise ValueError("Cannot infer batch size from an empty input.")
    return default_batch_size(leaves[0])


def _num_loss_terms_in_batch(loss_func: Loss, y: torch.Tensor) -> int:
    """Count the loss terms in a batch target (one per CE target entry,
    one per row of an MSE/BCE target)."""
    shape = tuple(y.shape)
    if isinstance(loss_func, CrossEntropyLoss):
        return math.prod(shape) if shape else 1
    return math.prod(shape[:-1]) if len(shape) > 1 else shape[0]
