"""Kronecker-product linear operator with closed-form properties and inverses.

PyTorch counterpart of ``curvlinops_tpu/ops/kronecker.py``. The matvec
reshapes the flat input into the grid of factor dimensions and contracts one
factor per axis, never forming the Kronecker product. Inversion offers three
damping modes: per-factor damping, the Martens-Grosse heuristic split
(arXiv:1503.05671 §6.3) with the zero-trace guard, and exact damping through
per-factor eigendecompositions. The damped Cholesky inverse retries in
float64 when the factorization fails in the working precision. The
embedding blocks (``G (x) diag(d)`` and its eigendecomposed form) keep the
one-hot input covariance as a vector.

Example:
    >>> import torch
    >>> from curvlinops_tpu_torch import KroneckerProductLinearOperator
    >>> gen = torch.Generator().manual_seed(0)
    >>> A = torch.randn((3, 3), generator=gen)
    >>> B = torch.randn((4, 4), generator=gen)
    >>> K = KroneckerProductLinearOperator(A, B)
    >>> v = torch.randn(12, generator=gen)
    >>> bool(torch.allclose(K @ v, torch.kron(A, B) @ v, atol=1e-5))
    True
    >>> bool(torch.allclose(K.trace(), torch.trace(A) * torch.trace(B), atol=1e-5))
    True
"""

from __future__ import annotations

import math
import warnings

import torch

from curvlinops_tpu_torch.ops.base import LinearOperator
from curvlinops_tpu_torch.ops.eigh import EighDecomposedLinearOperator
from curvlinops_tpu_torch.utils.flatten import TensorSpec


def kron_matmat(factors: list[torch.Tensor], M: torch.Tensor) -> torch.Tensor:
    """``(S_1 (x) ... (x) S_k) M`` for factors ``[m_i, n_i]`` and ``M [prod n, K]``.

    Each factor contracts the leading grid axis and its output dimension
    cycles to the back, so no factor needs a relayout of the operand.
    """
    K = M.shape[-1]
    x = M.reshape(*(S.shape[1] for S in factors), K).movedim(-1, 0)  # [K, g_1..g_k]
    for S in factors:
        x = torch.tensordot(x, S, dims=([1], [1]))  # [K, g_2.., m]
    return x.movedim(0, -1).reshape(-1, K)


def cholesky_failed(L: torch.Tensor, info: torch.Tensor) -> torch.Tensor:
    """Device-side flag: the factorization did not complete or produced NaN."""
    return (info != 0).any() | torch.isnan(L).any()


def damped_cholesky_inverse(
    A: torch.Tensor, damping: float | torch.Tensor, retry_double_precision: bool = True
) -> torch.Tensor:
    """Invert ``A + damping I`` via Cholesky, retrying in float64 on failure.

    ``A`` may be a stack ``[L, n, n]`` with ``damping`` a ``[L, 1, 1]``
    tensor in ``A``'s dtype (one damping per slice).

    Raises:
        RuntimeError: If the factorization fails even in float64 (or the
            retry is disabled).
    """

    def _inv(mat):
        eye = torch.eye(mat.shape[-1], dtype=mat.dtype, device=mat.device)
        L, info = torch.linalg.cholesky_ex(mat + damping * eye)
        return torch.cholesky_inverse(L), bool(cholesky_failed(L, info))

    inv, failed = _inv(A)
    if not failed:
        return inv
    if not retry_double_precision or A.dtype == torch.float64:
        raise RuntimeError(
            "Cholesky decomposition failed and double-precision retry is disabled."
        )
    warnings.warn(f"Cholesky failed in {A.dtype}; retrying in float64.", stacklevel=2)
    inv64, failed = _inv(A.double())
    if failed:
        raise RuntimeError("Cholesky decomposition failed in float64.")
    return inv64.to(A.dtype)


def heuristic_pi(mean1: float, mean2: float) -> float:
    """Martens-Grosse ``pi = sqrt(mean2 / mean1)``, or 1 when a trace is zero.

    A zero factor trace carries no scale information (MC-Fisher gradient
    factors underflow to exact zeros on saturated-softmax models), so the
    split degenerates to the plain one instead of an infinite ``pi``.
    """
    return math.sqrt(mean2 / mean1) if mean1 > 0 and mean2 > 0 else 1.0


class KroneckerProductLinearOperator(LinearOperator):
    """Lazy ``S_1 (x) S_2 (x) ... (x) S_k`` over flat vectors."""

    capturable = True

    def __init__(self, *factors: torch.Tensor):
        self._factors = list(factors)
        if not self._factors or any(S.ndim != 2 for S in self._factors):
            raise ValueError("Factors must be one or more matrices.")
        rows = math.prod(S.shape[0] for S in self._factors)
        cols = math.prod(S.shape[1] for S in self._factors)
        dtype, device = self._factors[0].dtype, self._factors[0].device
        super().__init__(
            TensorSpec((cols,), dtype, device), TensorSpec((rows,), dtype, device)
        )

    @property
    def factors(self) -> list[torch.Tensor]:
        """The Kronecker factors."""
        return self._factors

    def _matmat(self, M: torch.Tensor) -> torch.Tensor:
        return kron_matmat(self._factors, M)

    def _adjoint(self) -> "KroneckerProductLinearOperator":
        return KroneckerProductLinearOperator(*[S.conj().T for S in self._factors])

    def _ensure_square(self):
        if any(S.shape[0] != S.shape[1] for S in self._factors):
            raise ValueError("Operation requires square Kronecker factors.")

    def trace(self) -> torch.Tensor:
        """``tr = prod_i tr(S_i)``."""
        self._ensure_square()
        return math.prod(torch.trace(S) for S in self._factors)

    def det(self) -> torch.Tensor:
        """``det = prod_i det(S_i)^(N / n_i)``."""
        self._ensure_square()
        N = self.shape[0]
        return math.prod(torch.linalg.det(S) ** (N // S.shape[0]) for S in self._factors)

    def logdet(self) -> torch.Tensor:
        """``logdet = sum_i (N / n_i) logdet(S_i)``; NaN for a non-positive det."""
        self._ensure_square()
        N = self.shape[0]
        out = 0.0
        for S in self._factors:
            sign, ld = torch.linalg.slogdet(S)
            out = out + (N // S.shape[0]) * torch.where(sign > 0, ld, torch.nan)
        return out

    def frobenius_norm(self) -> torch.Tensor:
        """``||.||_F = prod_i ||S_i||_F``."""
        return math.prod(torch.linalg.matrix_norm(S) for S in self._factors)

    def inverse(
        self,
        damping: float = 0.0,
        use_heuristic_damping: bool = False,
        min_damping: float = 1e-8,
        use_exact_damping: bool = False,
        retry_double_precision: bool = True,
    ) -> LinearOperator:
        """Inverse with plain, Martens-Grosse heuristic or exact damping.

        Raises:
            ValueError: If both damping strategies are requested, or heuristic
                damping is requested for more than two factors.
            RuntimeError: If heuristic damping meets a negative mean eigenvalue.
        """
        self._ensure_square()
        if use_heuristic_damping and use_exact_damping:
            raise ValueError("Choose either heuristic or exact damping, not both.")

        if use_exact_damping:
            eig = [torch.linalg.eigh(S) for S in self._factors]
            eigvals = eig[0][0]
            for vals, _ in eig[1:]:
                eigvals = torch.kron(eigvals, vals)
            Q = KroneckerProductLinearOperator(*[vecs for _, vecs in eig])
            return EighDecomposedLinearOperator(eigvals, Q).inverse(damping=damping)

        if use_heuristic_damping and len(self._factors) > 2:
            raise ValueError(
                f"Heuristic damping supports at most two factors, got {len(self._factors)}."
            )
        if use_heuristic_damping and len(self._factors) == 2:
            mean1, mean2 = (float(torch.diagonal(S).mean()) for S in self._factors)
            if mean1 < 0 or mean2 < 0:
                raise RuntimeError("Negative mean eigenvalue detected.")
            pi = heuristic_pi(mean1, mean2)
            sqrt_damping = math.sqrt(damping)
            dampings = (
                max(sqrt_damping / pi, min_damping),
                max(sqrt_damping * pi, min_damping),
            )
        elif use_heuristic_damping:
            dampings = (max(damping, min_damping),)
        else:
            dampings = tuple(damping for _ in self._factors)

        return KroneckerProductLinearOperator(
            *[
                damped_cholesky_inverse(S, d, retry_double_precision)
                for S, d in zip(self._factors, dampings)
            ]
        )


class EmbeddingKroneckerOperator(LinearOperator):
    """``G (x) diag(d)``: the KFAC block of an embedding layer.

    One-hot layer inputs make the input covariance exactly diagonal (token
    counts), so the right Kronecker factor is a length-``V`` vector and the
    ``[V, V]`` matrix is never formed. Damping mirrors
    :class:`KroneckerProductLinearOperator` with the diagonal as the second
    factor.
    """

    capturable = True

    def __init__(self, G: torch.Tensor, d: torch.Tensor):
        self._G, self._d = torch.as_tensor(G), torch.as_tensor(d)
        if self._G.ndim != 2 or self._d.ndim != 1:
            raise ValueError("Need a [C, C] matrix and a [V] diagonal vector.")
        V = self._d.shape[0]
        dtype, device = torch.promote_types(self._G.dtype, self._d.dtype), self._G.device
        super().__init__(
            TensorSpec((self._G.shape[1] * V,), dtype, device),
            TensorSpec((self._G.shape[0] * V,), dtype, device),
        )

    @property
    def factors(self) -> list[torch.Tensor]:
        """``[G, d]``: the dense left factor and the diagonal vector."""
        return [self._G, self._d]

    def _matmat(self, M: torch.Tensor) -> torch.Tensor:
        K = M.shape[-1]
        X = M.reshape(self._G.shape[1], self._d.shape[0], K)
        out = torch.einsum("ab,bvk->avk", self._G, X) * self._d[None, :, None]
        return out.reshape(-1, K)

    def _adjoint(self) -> "EmbeddingKroneckerOperator":
        return EmbeddingKroneckerOperator(self._G.conj().T, self._d.conj())

    def _ensure_square(self):
        if self._G.shape[0] != self._G.shape[1]:
            raise ValueError("Operation requires a square left factor.")

    def trace(self) -> torch.Tensor:
        """``tr(G) * sum(d)``."""
        self._ensure_square()
        return torch.trace(self._G) * self._d.sum()

    def det(self) -> torch.Tensor:
        """``det(G)^V * prod(d)^C``."""
        self._ensure_square()
        V, C = self._d.shape[0], self._G.shape[0]
        return torch.linalg.det(self._G) ** V * self._d.prod() ** C

    def logdet(self) -> torch.Tensor:
        """``V logdet(G) + C sum(log d)``; NaN for a non-positive ``det(G)``."""
        self._ensure_square()
        V, C = self._d.shape[0], self._G.shape[0]
        sign, ld = torch.linalg.slogdet(self._G)
        return V * torch.where(sign > 0, ld, torch.nan) + C * self._d.log().sum()

    def frobenius_norm(self) -> torch.Tensor:
        """``||G||_F * ||d||_2``."""
        return torch.linalg.matrix_norm(self._G) * torch.linalg.vector_norm(self._d)

    def inverse(
        self,
        damping: float = 0.0,
        use_heuristic_damping: bool = False,
        min_damping: float = 1e-8,
        use_exact_damping: bool = False,
        retry_double_precision: bool = True,
    ) -> LinearOperator:
        """Damped inverse with plain, Martens-Grosse heuristic or exact damping.

        The heuristic split takes :func:`heuristic_pi`'s zero-trace guard: an
        all-zero ``G`` or ``d`` gives ``pi = 1`` and a finite inverse, where
        the JAX package's ``ops/kronecker.py:329`` divides by the zero trace.

        Raises:
            ValueError: If both damping strategies are requested.
            RuntimeError: On a negative mean eigenvalue under heuristic
                damping.
        """
        self._ensure_square()
        if use_heuristic_damping and use_exact_damping:
            raise ValueError("Choose either heuristic or exact damping, not both.")
        if use_exact_damping:
            lam_G, Q_G = torch.linalg.eigh(self._G)
            lam = lam_G[:, None] * self._d[None, :]
            return EmbeddingEighOperator(1.0 / (lam + damping), Q_G)
        if use_heuristic_damping:
            mean1, mean2 = float(torch.diagonal(self._G).mean()), float(self._d.mean())
            if mean1 < 0 or mean2 < 0:
                raise RuntimeError("Negative mean eigenvalue detected.")
            pi = heuristic_pi(mean1, mean2)
            sqrt_damping = math.sqrt(damping)
            d1 = max(sqrt_damping / pi, min_damping)
            d2 = max(sqrt_damping * pi, min_damping)
        else:
            d1 = d2 = damping
        return EmbeddingKroneckerOperator(
            damped_cholesky_inverse(self._G, d1, retry_double_precision),
            1.0 / (self._d + d2),
        )


class EmbeddingEighOperator(LinearOperator):
    """``(Q (x) I) diag(lam) (Q (x) I)^T``: an eigendecomposed embedding block.

    The diagonal right factor's eigenbasis is the identity, so only the
    ``[C, C]`` left eigenvectors are stored; the eigenvalues are the full
    ``[C, V]`` grid ``lam_G (x) d``.
    """

    SELF_ADJOINT = True
    capturable = True

    def __init__(self, eigenvalues: torch.Tensor, Q: torch.Tensor):
        self._lam, self._Q = torch.as_tensor(eigenvalues), torch.as_tensor(Q)  # [C, V], [C, C]
        if self._lam.ndim != 2 or self._Q.ndim != 2:
            raise ValueError("Need [C, V] eigenvalues and [C, C] eigenvectors.")
        super().__init__(TensorSpec((self._lam.numel(),), self._lam.dtype, self._lam.device))

    @property
    def eigenvalues(self) -> torch.Tensor:
        """The ``[C, V]`` eigenvalue grid."""
        return self._lam

    def _matmat(self, M: torch.Tensor) -> torch.Tensor:
        K = M.shape[-1]
        X = M.reshape(*self._lam.shape, K)
        W = torch.einsum("ba,bvk->avk", self._Q, X) * self._lam[:, :, None]  # diag(lam) Q^T X
        return torch.einsum("ab,bvk->avk", self._Q, W).reshape(-1, K)

    def trace(self) -> torch.Tensor:
        """Sum of eigenvalues."""
        return self._lam.sum()

    def det(self) -> torch.Tensor:
        """Product of eigenvalues."""
        return self._lam.prod()

    def logdet(self) -> torch.Tensor:
        """Sum of log eigenvalues."""
        return self._lam.log().sum()

    def frobenius_norm(self) -> torch.Tensor:
        """L2 norm of the eigenvalues."""
        return torch.linalg.vector_norm(self._lam)

    def inverse(self, damping: float = 0.0) -> "EmbeddingEighOperator":
        """``1/(lam + delta)`` in the same basis."""
        return EmbeddingEighOperator(1.0 / (self._lam + damping), self._Q)
