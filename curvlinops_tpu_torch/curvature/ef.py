"""Row flattening of predictions and targets (empirical-Fisher helpers).

PyTorch counterpart of the two helpers in ``curvlinops_tpu/curvature/ef.py``
that the KFAC computer needs: per-loss-term predictions are flattened to rows
``[num_loss_terms, C]`` (CE: ``[N, C, *d] -> [(N *d), C]``; MSE/BCE:
``[N, *d, C] -> [(N *d), C]``). The ``EFLinearOperator`` itself is not ported
yet.
"""

from __future__ import annotations

import torch

from curvlinops_tpu_torch.losses import CrossEntropyLoss


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
