"""Model-function plumbing for the curvature operators.

PyTorch counterpart of the part of ``curvlinops_tpu/utils/misc.py`` that the
operators need. The JAX package's ``FrozenModelFn`` / ``unwrap_model_fn``
keep the non-differentiated parameters out of jitted programs; here an
``nn.Module`` holds them itself: the operators differentiate w.r.t. a dict
of named parameters and apply the module with
``torch.func.functional_call(model, params, (X,))``, so every other
parameter and buffer stays fixed.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
from torch import nn


def as_model_fn(model: nn.Module | Callable) -> Callable[[Any, Any], torch.Tensor]:
    """``(params, X) -> prediction`` for an ``nn.Module`` or a plain callable.

    Raises:
        ValueError: If ``model`` is neither.
    """
    if isinstance(model, nn.Module):
        return lambda params, X: torch.func.functional_call(model, params, (X,))
    if callable(model):
        return model
    raise ValueError(
        "model must be an nn.Module or a callable (params, X) -> prediction, "
        f"got {type(model).__name__}."
    )
