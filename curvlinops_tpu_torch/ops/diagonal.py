"""Diagonal linear operator over a tree space.

PyTorch counterpart of ``curvlinops_tpu/ops/diagonal.py``: elementwise
multiplication per leaf; closed under ``+``, ``@`` and scalar ``*`` (each
returns a ``DiagonalLinearOperator``); damped inverse ``1 / (d + delta)``;
exact trace, determinant, log-determinant and Frobenius norm.
"""

from __future__ import annotations

from typing import Any

import torch
from torch.utils import _pytree as pytree

from curvlinops_tpu_torch.ops.base import LinearOperator
from curvlinops_tpu_torch.utils.flatten import spec_of


class DiagonalLinearOperator(LinearOperator):
    """Operator ``diag(d)`` where ``d`` is a tree of tensors matching the space."""

    SELF_ADJOINT = True
    capturable = True

    def __init__(self, diagonal: Any):
        """Store the diagonal as a tree of tensors."""
        self._diag = pytree.tree_map(torch.as_tensor, diagonal)
        super().__init__(spec_of(self._diag))

    @property
    def diagonal(self) -> Any:
        """The tree of diagonal entries."""
        return self._diag

    def _leaves(self) -> list[torch.Tensor]:
        return pytree.tree_leaves(self._diag)

    def _matmat(self, M: Any) -> Any:
        return pytree.tree_map(lambda d, m: d[..., None] * m, self._diag, M)

    def __add__(self, other):
        if isinstance(other, DiagonalLinearOperator):
            return DiagonalLinearOperator(pytree.tree_map(torch.add, self._diag, other._diag))
        return super().__add__(other)

    def __mul__(self, scalar):
        if isinstance(scalar, (int, float)) or (
            isinstance(scalar, torch.Tensor) and scalar.ndim == 0
        ):
            return DiagonalLinearOperator(pytree.tree_map(lambda d: scalar * d, self._diag))
        return super().__mul__(scalar)

    __rmul__ = __mul__

    def __matmul__(self, other):
        if isinstance(other, DiagonalLinearOperator):
            return DiagonalLinearOperator(pytree.tree_map(torch.mul, self._diag, other._diag))
        return super().__matmul__(other)

    def inverse(self, damping: float = 0.0) -> "DiagonalLinearOperator":
        """Damped inverse ``diag(1 / (d + damping))``."""
        return DiagonalLinearOperator(pytree.tree_map(lambda d: 1.0 / (d + damping), self._diag))

    def trace(self) -> torch.Tensor:
        """Exact trace."""
        return sum(d.sum() for d in self._leaves())

    def det(self) -> torch.Tensor:
        """Exact determinant."""
        leaves = [d.prod() for d in self._leaves()]
        out = leaves[0]
        for leaf in leaves[1:]:
            out = out * leaf
        return out

    def logdet(self) -> torch.Tensor:
        """Exact log-determinant (requires a positive diagonal)."""
        return sum(d.log().sum() for d in self._leaves())

    def frobenius_norm(self) -> torch.Tensor:
        """Exact Frobenius norm."""
        return torch.sqrt(sum((d * d).sum() for d in self._leaves()))
