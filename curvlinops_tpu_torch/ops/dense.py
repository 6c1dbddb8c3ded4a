"""Explicitly represented operators: dense matrix, identity, outer product.

PyTorch counterpart of ``curvlinops_tpu/ops/dense.py``. Each lives on the
device of the tensor it is given; the identity lives on its space's device.
"""

from __future__ import annotations

from typing import Any

import torch

from curvlinops_tpu_torch.ops.base import LinearOperator
from curvlinops_tpu_torch.utils.flatten import TensorSpec


def _vector_spec(dim: int, like: torch.Tensor) -> TensorSpec:
    return TensorSpec((dim,), like.dtype, like.device)


class MatrixLinearOperator(LinearOperator):
    """Wraps an explicit dense matrix ``A`` as an operator on flat vectors.

    ``SELF_ADJOINT`` is False; set it on the instance for a symmetric ``A``.
    """

    capturable = True

    def __init__(self, A):
        A = torch.as_tensor(A)
        if A.ndim != 2:
            raise ValueError(f"Expected a matrix, got shape {tuple(A.shape)}.")
        super().__init__(_vector_spec(A.shape[1], A), _vector_spec(A.shape[0], A))
        self.A = A

    def _matmat(self, M: torch.Tensor) -> torch.Tensor:
        return self.A @ M

    def _adjoint(self) -> "MatrixLinearOperator":
        return MatrixLinearOperator(self.A.conj().T)

    def todense(self, col_chunk: int | None = None) -> torch.Tensor:  # noqa: D102
        return self.A


class IdentityLinearOperator(LinearOperator):
    """Identity on an arbitrary tree space."""

    SELF_ADJOINT = True
    capturable = True

    def __init__(self, spec: Any):
        super().__init__(spec)

    def _matmat(self, M: Any) -> Any:
        return M


class OuterProductLinearOperator(LinearOperator):
    """Low-rank operator ``c * U U^T`` for ``U`` of shape ``[N, R]``."""

    SELF_ADJOINT = True
    capturable = True

    def __init__(self, U, c: float = 1.0):
        U = torch.as_tensor(U)
        if U.ndim == 1:
            U = U[:, None]
        super().__init__(_vector_spec(U.shape[0], U))
        self.U, self.c = U, c

    def _matmat(self, M: torch.Tensor) -> torch.Tensor:
        return self.c * (self.U @ (self.U.conj().T @ M))
