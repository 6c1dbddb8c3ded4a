"""Block-diagonal linear operator.

PyTorch counterpart of ``curvlinops_tpu/ops/blockdiag.py``: holds child
operators, routes each block of the input through its child, and reduces
closed-form matrix properties over the blocks. The input space is the tuple
of the children's input spaces, so flat vectors split at the format edge.
"""

from __future__ import annotations

from typing import Sequence

import torch

from curvlinops_tpu_torch.ops.base import LinearOperator


class BlockDiagonalLinearOperator(LinearOperator):
    """``blockdiag(A_1, ..., A_k)`` over a tuple of the blocks' spaces."""

    def __init__(self, blocks: Sequence[LinearOperator]):
        blocks = list(blocks)
        if not blocks:
            raise ValueError("Need at least one block.")
        super().__init__(
            tuple(b.in_spec for b in blocks), tuple(b.out_spec for b in blocks)
        )
        self.blocks = blocks
        self.SELF_ADJOINT = all(b.SELF_ADJOINT for b in blocks)

    def __len__(self) -> int:  # noqa: D105
        return len(self.blocks)

    def __getitem__(self, idx: int) -> LinearOperator:  # noqa: D105
        return self.blocks[idx]

    def _matmat(self, M: tuple) -> tuple:
        return tuple(block._matmat(m) for block, m in zip(self.blocks, M))

    def _adjoint(self) -> "BlockDiagonalLinearOperator":
        return BlockDiagonalLinearOperator([b.adjoint() for b in self.blocks])

    def trace(self) -> torch.Tensor:
        """Sum of block traces."""
        return sum(b.trace() for b in self.blocks)

    def det(self) -> torch.Tensor:
        """Product of block determinants."""
        out = self.blocks[0].det()
        for b in self.blocks[1:]:
            out = out * b.det()
        return out

    def logdet(self) -> torch.Tensor:
        """Sum of block log-determinants."""
        return sum(b.logdet() for b in self.blocks)

    def frobenius_norm(self) -> torch.Tensor:
        """Square root of the summed squared block Frobenius norms."""
        return torch.sqrt(sum(b.frobenius_norm() ** 2 for b in self.blocks))

    def inverse(self, **kwargs) -> "BlockDiagonalLinearOperator":
        """Blockwise inverse, forwarding damping options to each block."""
        return BlockDiagonalLinearOperator([b.inverse(**kwargs) for b in self.blocks])
