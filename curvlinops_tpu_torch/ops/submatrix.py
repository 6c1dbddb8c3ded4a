"""Submatrix of a linear operator: ``A[row_idxs][:, col_idxs]``.

PyTorch counterpart of ``curvlinops_tpu/ops/submatrix.py``: scatter the
input into the full column space, apply ``A``, gather the requested rows.
Works matrix-free for any operator; the adjoint swaps the index lists.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from curvlinops_tpu_torch.ops.base import LinearOperator
from curvlinops_tpu_torch.utils.flatten import TensorSpec


def _validate_indices(idxs: Sequence[int], dim: int, name: str) -> np.ndarray:
    arr = np.asarray(idxs.cpu() if isinstance(idxs, torch.Tensor) else idxs)
    if arr.ndim != 1 or arr.size == 0:
        raise ValueError(f"{name} must be a non-empty 1d sequence of ints.")
    if not np.issubdtype(arr.dtype, np.integer):
        raise ValueError(f"{name} must contain integers, got {arr.dtype}.")
    if len(np.unique(arr)) != len(arr):
        raise ValueError(f"{name} must not contain duplicates.")
    if arr.min() < 0 or arr.max() >= dim:
        raise ValueError(f"{name} out of range for dimension {dim}.")
    return arr


class SubmatrixLinearOperator(LinearOperator):
    """``A[row_idxs][:, col_idxs]`` as a matrix-free operator on flat vectors."""

    def __init__(self, A: LinearOperator, row_idxs, col_idxs):
        self._A = A
        rows = _validate_indices(row_idxs, A.shape[0], "row_idxs")
        cols = _validate_indices(col_idxs, A.shape[1], "col_idxs")
        self._row_idxs = torch.as_tensor(rows, device=A.device)
        self._col_idxs = torch.as_tensor(cols, device=A.device)
        super().__init__(
            TensorSpec((len(cols),), A.dtype, A.device),
            TensorSpec((len(rows),), A.dtype, A.device),
        )

    @property
    def capturable(self) -> bool:  # noqa: D102
        return self._A.capturable

    def _matmat(self, M: torch.Tensor) -> torch.Tensor:
        full = torch.zeros((self._A.shape[1], M.shape[-1]), dtype=M.dtype, device=M.device)
        full[self._col_idxs] = M
        return (self._A @ full)[self._row_idxs]

    def _adjoint(self) -> "SubmatrixLinearOperator":
        return SubmatrixLinearOperator(self._A.adjoint(), self._col_idxs, self._row_idxs)
