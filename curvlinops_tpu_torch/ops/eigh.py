"""Eigendecomposed linear operator ``Q diag(lam) Q^T``.

PyTorch counterpart of ``curvlinops_tpu/ops/eigh.py``. ``Q`` may be a dense
matrix or any ``LinearOperator`` on flat vectors (the KFAC exact-damping
inverse stores the Kronecker product of the factors' eigenvector bases).
Closed-form trace/det/logdet/Frobenius norm come from the eigenvalues; the
damped inverse reuses ``Q`` with ``1 / (lam + delta)``.
"""

from __future__ import annotations

from typing import Union

import torch

from curvlinops_tpu_torch.ops.base import LinearOperator
from curvlinops_tpu_torch.utils.flatten import TensorSpec


class EighDecomposedLinearOperator(LinearOperator):
    """Operator ``Q diag(eigenvalues) Q^T``."""

    SELF_ADJOINT = True

    def __init__(self, eigenvalues: torch.Tensor, Q: Union[torch.Tensor, LinearOperator]):
        if eigenvalues.ndim != 1:
            raise ValueError("Eigenvalues must be a vector.")
        n = eigenvalues.shape[0]
        if tuple(Q.shape) != (n, n):
            raise ValueError(f"Q has shape {tuple(Q.shape)}, expected {(n, n)}.")
        super().__init__(TensorSpec((n,), eigenvalues.dtype, eigenvalues.device))
        self._eigenvalues = eigenvalues
        self._Q = Q
        self._Q_adj = None  # lazily cached adjoint of an operator Q

    @property
    def capturable(self) -> bool:  # noqa: D102
        return not isinstance(self._Q, LinearOperator) or self._Q.capturable

    @property
    def eigenvalues(self) -> torch.Tensor:
        """The eigenvalues."""
        return self._eigenvalues

    @property
    def Q(self) -> Union[torch.Tensor, LinearOperator]:
        """The eigenvector basis (matrix or operator)."""
        return self._Q

    def _matmat(self, M: torch.Tensor) -> torch.Tensor:
        if isinstance(self._Q, LinearOperator):
            if self._Q_adj is None:
                self._Q_adj = self._Q.adjoint()
            W = self._eigenvalues[:, None] * self._Q_adj._matmat(M)
            return self._Q._matmat(W)
        W = self._eigenvalues[:, None] * (self._Q.T @ M)
        return self._Q @ W

    def trace(self) -> torch.Tensor:
        """Exact trace ``sum(lam)``."""
        return self._eigenvalues.sum()

    def det(self) -> torch.Tensor:
        """Exact determinant ``prod(lam)``."""
        return self._eigenvalues.prod()

    def logdet(self) -> torch.Tensor:
        """Exact log-determinant ``sum(log lam)``."""
        return self._eigenvalues.log().sum()

    def frobenius_norm(self) -> torch.Tensor:
        """Exact Frobenius norm ``sqrt(sum(lam^2))``."""
        return torch.linalg.vector_norm(self._eigenvalues)

    def inverse(self, damping: float = 0.0) -> "EighDecomposedLinearOperator":
        """Damped inverse ``Q diag(1/(lam + delta)) Q^T``."""
        return EighDecomposedLinearOperator(1.0 / (self._eigenvalues + damping), self._Q)
