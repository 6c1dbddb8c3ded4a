"""Shared model utilities: initializers and problem containers."""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import torch
from torch import nn


@dataclass
class Problem:
    """A benchmark problem: model, loss, parameters and one data batch.

    The JAX package's functional ``model_fn`` is an ``nn.Module`` here, and
    ``kfac_params`` names the parameters KFAC covers (conv/linear weights and
    biases with all dims <= 50k); the remaining parameters stay in the module.
    """

    name: str
    model: nn.Module
    loss_fn: Any
    params: dict
    data: list
    kfac_params: dict | None = None


def he_normal(
    shape: tuple, fan_in: int, generator: torch.Generator, dtype=torch.float32
) -> torch.Tensor:
    """He-normal initialization (drawn on the CPU from ``generator``)."""
    return torch.randn(shape, generator=generator, dtype=dtype) * math.sqrt(2.0 / fan_in)
