"""Stochastic diagonal estimators: Hutchinson and XDiag.

PyTorch counterpart of ``curvlinops_tpu/estimators/diagonal.py``; XDiag's
leave-one-out loop is batched as in XTrace. Each estimator draws its
probes and hands them to a core that takes the probe matrix.
"""

from __future__ import annotations

import torch

from curvlinops_tpu_torch.estimators.sampling import operator_probes
from curvlinops_tpu_torch.estimators.trace import (
    _check_matvecs,
    _check_square,
    _deflate,
    leave_one_out_basis,
)


def hutchinson_diag_core(A, G: torch.Tensor) -> torch.Tensor:
    """``1/N sum_k g_k (.) A g_k`` over the probe columns of ``G``."""
    return (G * (A @ G)).sum(1) / G.shape[1]


def hutchinson_diag(
    A,
    num_matvecs: int,
    distribution: str = "rademacher",
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    """``diag(A) ~ 1/N sum v (.) A v`` in one blocked matmat."""
    dim = _check_square(A)
    _check_matvecs(dim, num_matvecs, 1)
    return hutchinson_diag_core(A, operator_probes(A, generator, dim, num_matvecs, distribution))


def xdiag_core(A, W: torch.Tensor) -> torch.Tensor:
    """XDiag on the Rademacher probe columns of ``W``."""
    m = W.shape[1]
    A_W = A @ W
    Q, R = torch.linalg.qr(A_W)
    # Q^T A through the adjoint: A^T Q, transposed
    QT_A = (A.adjoint() @ Q).T
    diag_full = (Q * QT_A.T).sum(1)
    S = leave_one_out_basis(R)
    # diag(Q S S^T Q^T A) / m
    diag_correction = ((Q @ (S @ S.T)) * QT_A.T).sum(1) / m
    # batched deflated Hutchinson over the left-out vectors
    A_comp_W = A_W - Q @ _deflate(S, QT_A @ W)
    diag_hutch = (W * A_comp_W / W**2).sum(1) / m
    return diag_full - diag_correction + diag_hutch


def xdiag(A, num_matvecs: int, generator: torch.Generator | None = None) -> torch.Tensor:
    """XDiag (Epperly et al., 2024); Rademacher probes only."""
    dim = _check_square(A)
    _check_matvecs(dim, num_matvecs, 2)
    return xdiag_core(A, operator_probes(A, generator, dim, num_matvecs // 2, "rademacher"))
