"""Stochastic squared-Frobenius-norm estimation.

PyTorch counterpart of ``curvlinops_tpu/estimators/norm.py``:
``||A||_F^2 = tr(A^T A)`` estimated as ``sum((A G)^2) / N``; a wide
operator is transposed first, so the probes live in the smaller space.
"""

from __future__ import annotations

import torch

from curvlinops_tpu_torch.estimators.sampling import operator_probes


def _tall(A):
    """``A``, or its adjoint when ``A`` is wide."""
    rows, cols = A.shape
    return A.adjoint() if rows < cols else A


def squared_fro_terms(A, G: torch.Tensor) -> torch.Tensor:
    """``[||A g_k||^2 for each probe column g_k of G]``; ``G`` has as many
    rows as the smaller of ``A``'s dimensions (a wide ``A`` is transposed)."""
    return ((_tall(A) @ G) ** 2).sum(0)


def hutchinson_squared_fro_core(A, G: torch.Tensor) -> torch.Tensor:
    """The estimate on the probe columns of ``G``."""
    return squared_fro_terms(A, G).mean()


def hutchinson_squared_fro(
    A,
    num_matvecs: int,
    distribution: str = "rademacher",
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    """Estimate ``||A||_F^2`` with ``num_matvecs`` probe products."""
    if num_matvecs >= min(A.shape):
        raise ValueError(
            f"num_matvecs ({num_matvecs}) must be smaller than the smallest "
            f"dimension of {tuple(A.shape)}."
        )
    G = operator_probes(A, generator, min(A.shape), num_matvecs, distribution)
    return hutchinson_squared_fro_core(A, G)
