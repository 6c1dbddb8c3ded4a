"""Stochastic trace estimators: Hutchinson, Hutch++, XTrace.

PyTorch counterpart of ``curvlinops_tpu/estimators/trace.py``. Each
estimator draws its probes (:mod:`.sampling`) and hands them to a core that
takes the probe matrices, so the same probes can be fed to the core from
elsewhere (the tests feed the JAX package's). Every probe product is one
blocked matmat with the probes as columns, and XTrace's leave-one-out
algebra is batched over all left-out vectors at once (the JAX package's
form, not the reference's per-vector loop); nothing is read to the host.
"""

from __future__ import annotations

import torch

from curvlinops_tpu_torch.estimators.sampling import (
    next_default_generator,
    operator_probes,
    random_matrix,
)


def _check_square(A) -> int:
    rows, cols = A.shape
    if rows != cols:
        raise ValueError(f"Operator must be square, got {tuple(A.shape)}.")
    return rows


def _check_matvecs(dim: int, num_matvecs: int, divisor: int) -> None:
    if num_matvecs >= dim:
        raise ValueError(
            f"num_matvecs ({num_matvecs}) must be smaller than the dimension "
            f"({dim}); otherwise compute the target exactly."
        )
    if num_matvecs % divisor != 0:
        raise ValueError(f"num_matvecs must be divisible by {divisor}.")


def hutchinson_trace_terms(A, G: torch.Tensor) -> torch.Tensor:
    """``[g_k^T A g_k for each probe column g_k of G]`` (one matmat)."""
    return (G * (A @ G)).sum(0)


def hutchinson_trace_core(A, G: torch.Tensor) -> torch.Tensor:
    """Girard-Hutchinson on the probe columns of ``G``."""
    return hutchinson_trace_terms(A, G).mean()


def hutchinson_trace(
    A,
    num_matvecs: int,
    distribution: str = "rademacher",
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    """Girard-Hutchinson estimator ``tr(A) ~ 1/N sum v^T A v`` (one matmat)."""
    dim = _check_square(A)
    _check_matvecs(dim, num_matvecs, 1)
    return hutchinson_trace_core(A, operator_probes(A, generator, dim, num_matvecs, distribution))


def hutchpp_trace_core(A, S: torch.Tensor, G: torch.Tensor) -> torch.Tensor:
    """Hutch++ on the sketch probes ``S`` and the Hutchinson probes ``G``."""
    Q, _ = torch.linalg.qr(A @ S)
    # deflate the probes against the sketch basis
    G_defl = G - Q @ (Q.T @ G)
    tr_lowrank = (Q * (A @ Q)).sum()
    tr_residual = (G_defl * (A @ G_defl)).sum() / G.shape[1]
    return tr_lowrank + tr_residual


def hutchpp_trace(
    A,
    num_matvecs: int,
    distribution: str = "rademacher",
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    """Hutch++ (Meyer et al., 2020): exact low-rank part + deflated Hutchinson."""
    dim = _check_square(A)
    _check_matvecs(dim, num_matvecs, 3)
    m = num_matvecs // 3
    gen = next_default_generator(generator, A.device)
    S = random_matrix(gen, dim, m, distribution, A.dtype, A.device)
    G = random_matrix(gen, dim, m, distribution, A.dtype, A.device)
    return hutchpp_trace_core(A, S, G)


def leave_one_out_basis(R: torch.Tensor) -> torch.Tensor:
    """Columns ``s_i`` with ``Q_i Q_i^T = Q (I - s_i s_i^T) Q^T`` for the
    basis ``Q`` of ``A W = Q R`` without its ``i``-th probe."""
    RT_inv = torch.linalg.inv(R.T)
    return RT_inv / torch.sqrt((RT_inv**2).sum(0))


def _deflate(S: torch.Tensor, M: torch.Tensor) -> torch.Tensor:
    """``M[:, i] - s_i s_i^T M[:, i]`` for every column ``i`` at once."""
    return M - S * (S * M).sum(0)


def xtrace_core(A, W: torch.Tensor) -> torch.Tensor:
    """XTrace on the probe columns of ``W``."""
    A_W = A @ W
    Q, R = torch.linalg.qr(A_W)
    A_Q = A @ Q
    tr_full = (Q * A_Q).sum()
    S = leave_one_out_basis(R)
    # diag(S^T (Q^T A Q) S): the trace of each leave-one-out projection
    tr_loo = (S * ((Q.T @ A_Q) @ S)).sum(0)
    # deflated Hutchinson per left-out vector, batched over all of them
    A_P_W = A_W - A_Q @ _deflate(S, Q.T @ W)
    PT_A_P_W = A_P_W - Q @ _deflate(S, Q.T @ A_P_W)
    tr_hutch = (W * PT_A_P_W).sum(0)
    return (tr_full - tr_loo + tr_hutch).mean()


def xtrace(
    A,
    num_matvecs: int,
    distribution: str = "rademacher",
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    """XTrace (Epperly et al., 2024): exchangeable leave-one-out estimator."""
    dim = _check_square(A)
    _check_matvecs(dim, num_matvecs, 2)
    return xtrace_core(A, operator_probes(A, generator, dim, num_matvecs // 2, distribution))
