"""Stacked (batched) structured operators for stacked layer groups.

PyTorch counterpart of ``curvlinops_tpu/ops/stacked.py``. ``L``
independent Kronecker or eigendecomposed blocks whose factors share a shape
are held as single tensors with a leading stack axis (``[L, n, n]``) and
applied with one batched contraction per factor, never as per-slice copies.
"""

from __future__ import annotations

import math

import torch

from curvlinops_tpu_torch.ops.base import LinearOperator
from curvlinops_tpu_torch.utils.flatten import TensorSpec


def stacked_kron_matmat(factors: list[torch.Tensor], M: torch.Tensor) -> torch.Tensor:
    """Batched Kronecker matmat: factors ``[L, m_i, n_i]``, ``M [L*prod n, K]``.

    The operand is kept in ``[L, K, grid...]`` order, so each factor is one
    batched ``einsum`` that contracts the leading grid axis (always axis 2)
    and cycles its output dimension to the back.
    """
    L, K = factors[0].shape[0], M.shape[-1]
    x = M.reshape(L, *(S.shape[2] for S in factors), K).movedim(-1, 1)  # [L, K, g_1..g_k]
    for S in factors:
        x = torch.einsum("lkg...,lmg->lk...m", x, S)  # [L, K, g_2.., m]
    return x.movedim(1, -1).reshape(-1, K)


def _flat_spec(size: int, like: torch.Tensor) -> TensorSpec:
    return TensorSpec((size,), like.dtype, like.device)


class StackedKroneckerOperator(LinearOperator):
    """``blockdiag_l ( S_1[l] (x) ... (x) S_k[l] )`` over flat vectors."""

    capturable = True

    def __init__(self, *factors: torch.Tensor):
        self._factors = [torch.as_tensor(S) for S in factors]
        if not self._factors or any(S.ndim != 3 for S in self._factors):
            raise ValueError("Factors must be one or more [L, m, n] stacks.")
        L = self._factors[0].shape[0]
        if any(S.shape[0] != L for S in self._factors):
            raise ValueError("All factor stacks must share the stack length.")
        rows = L * math.prod(S.shape[1] for S in self._factors)
        cols = L * math.prod(S.shape[2] for S in self._factors)
        S0 = self._factors[0]
        super().__init__(_flat_spec(cols, S0), _flat_spec(rows, S0))

    @property
    def factors(self) -> list[torch.Tensor]:
        """The stacked Kronecker factors ``[L, m_i, n_i]``."""
        return self._factors

    @property
    def stack(self) -> int:
        """Number of independent blocks."""
        return self._factors[0].shape[0]

    def _matmat(self, M: torch.Tensor) -> torch.Tensor:
        return stacked_kron_matmat(self._factors, M)

    def _adjoint(self) -> "StackedKroneckerOperator":
        return StackedKroneckerOperator(*[S.conj().transpose(-1, -2) for S in self._factors])

    def _ensure_square(self):
        if any(S.shape[1] != S.shape[2] for S in self._factors):
            raise ValueError("Operation requires square Kronecker factors.")

    def trace(self) -> torch.Tensor:
        """``sum_l prod_i tr(S_i[l])``."""
        self._ensure_square()
        per_l = math.prod(S.diagonal(dim1=-2, dim2=-1).sum(-1) for S in self._factors)
        return per_l.sum()

    def logdet(self) -> torch.Tensor:
        """``sum_l sum_i (N_l / n_i) logdet(S_i[l])``; NaN for a non-positive det."""
        self._ensure_square()
        N = math.prod(S.shape[1] for S in self._factors)
        out = 0.0
        for S in self._factors:
            sign, ld = torch.linalg.slogdet(S)
            out = out + (N // S.shape[1]) * torch.where(sign > 0, ld, torch.nan).sum()
        return out

    def det(self) -> torch.Tensor:
        """``prod_l prod_i det(S_i[l])^(N_l / n_i)``."""
        self._ensure_square()
        N = math.prod(S.shape[1] for S in self._factors)
        return math.prod(
            (torch.linalg.det(S) ** (N // S.shape[1])).prod() for S in self._factors
        )

    def frobenius_norm(self) -> torch.Tensor:
        """``sqrt(sum_l prod_i ||S_i[l]||_F^2)``."""
        per_l = math.prod((S * S).sum(dim=(-2, -1)) for S in self._factors)
        return per_l.sum().sqrt()

    def inverse(
        self,
        damping: float = 0.0,
        use_heuristic_damping: bool = False,
        min_damping: float = 1e-8,
        use_exact_damping: bool = False,
        retry_double_precision: bool = True,
    ) -> LinearOperator:
        """Damped inverse, batched over the stack: plain, Martens-Grosse
        heuristic (with the zero-trace guard) or exact damping.

        Raises:
            ValueError: If both damping strategies are requested.
        """
        from curvlinops_tpu_torch.kfac.chain import stacked_kron_inverse

        self._ensure_square()
        if use_heuristic_damping and use_exact_damping:
            raise ValueError("Choose either heuristic or exact damping, not both.")
        if use_exact_damping:
            eig = [torch.linalg.eigh(S) for S in self._factors]
            lam = eig[0][0]
            for vals, _ in eig[1:]:
                lam = (lam[..., :, None] * vals[..., None, :]).reshape(self.stack, -1)
            return StackedEighOperator(1.0 / (lam + damping), [vecs for _, vecs in eig])
        return StackedKroneckerOperator(
            *stacked_kron_inverse(
                self._factors, damping, use_heuristic_damping, min_damping,
                retry_double_precision,
            )
        )


class StackedEighOperator(LinearOperator):
    """``blockdiag_l ( Q[l] diag(lam[l]) Q[l]^T )`` with Kronecker ``Q[l]``."""

    SELF_ADJOINT = True
    capturable = True

    def __init__(self, eigenvalues: torch.Tensor, q_factors: list[torch.Tensor]):
        self._lam = torch.as_tensor(eigenvalues)  # [L, D]
        self._Qs = [torch.as_tensor(Q) for Q in q_factors]  # [L, n_i, n_i]
        if self._lam.ndim != 2 or any(Q.ndim != 3 for Q in self._Qs):
            raise ValueError("Need [L, D] eigenvalues and [L, n, n] eigenvector stacks.")
        if self._lam.shape[1] != math.prod(Q.shape[1] for Q in self._Qs):
            raise ValueError("Eigenvalue count must match prod of Q dims.")
        super().__init__(_flat_spec(self._lam.numel(), self._lam))

    @property
    def eigenvalues(self) -> torch.Tensor:
        """The per-block eigenvalues ``[L, D]``."""
        return self._lam

    @property
    def stack(self) -> int:
        """Number of independent blocks."""
        return self._lam.shape[0]

    def _matmat(self, M: torch.Tensor) -> torch.Tensor:
        W = stacked_kron_matmat([Q.transpose(-1, -2) for Q in self._Qs], M)
        return stacked_kron_matmat(self._Qs, self._lam.reshape(-1, 1) * W)

    def trace(self) -> torch.Tensor:
        """Sum of all eigenvalues."""
        return self._lam.sum()

    def det(self) -> torch.Tensor:
        """Product of all eigenvalues."""
        return self._lam.prod()

    def logdet(self) -> torch.Tensor:
        """Sum of log eigenvalues."""
        return self._lam.log().sum()

    def frobenius_norm(self) -> torch.Tensor:
        """L2 norm of the eigenvalues."""
        return torch.linalg.vector_norm(self._lam)

    def inverse(self, damping: float = 0.0) -> "StackedEighOperator":
        """``1/(lam + delta)`` in the same basis."""
        return StackedEighOperator(1.0 / (self._lam + damping), self._Qs)
