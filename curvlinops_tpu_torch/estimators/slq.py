"""Stochastic Lanczos quadrature: ``tr(f(A))`` for matrix functions.

PyTorch counterpart of ``curvlinops_tpu/estimators/slq.py`` (Ubaru, Chen &
Saad 2017). Per Rademacher probe ``v`` (``||v||^2 == dim``), ``ncv``
Lanczos steps give the tridiagonal eigenpairs ``(theta, U)``, and Gauss
quadrature reads ``v^T f(A) v ~ dim * sum_k U[0, k]^2 f(theta_k)``.

The JAX package maps the one-vector Lanczos loop over the probes inside one
cached program. Here all ``num_repeats`` probes are the columns of one
block, and each Lanczos step is one operator matmat
(:func:`~curvlinops_tpu_torch.solvers.lanczos.fast_lanczos_columns`), so a
curvature operator's ``max_vmap_columns`` still bounds its memory. The loop
reads nothing to the host. The quadrature nodes and weights do not depend
on ``f``, which enters only in the final reduction. No
reorthogonalization: duplicate Ritz values split their weights, which
leaves ``tr(f(A))`` well behaved.
"""

from __future__ import annotations

from typing import Callable

import torch

from curvlinops_tpu_torch.estimators.sampling import next_default_generator, rademacher
from curvlinops_tpu_torch.estimators.trace import _check_square
from curvlinops_tpu_torch.solvers.lanczos import fast_lanczos_columns


def slq_quadrature(A, V: torch.Tensor, ncv: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Gauss-quadrature ``(nodes, weights)``, each ``[R, ncv]``, from ``ncv``
    Lanczos steps on the probe columns of ``V`` ``[dim, R]``."""
    evals, evecs = fast_lanczos_columns(A, V, ncv)
    return evals, evecs[:, 0, :] ** 2


def slq_function_trace_core(
    A, f: Callable[[torch.Tensor], torch.Tensor], V: torch.Tensor, ncv: int
) -> torch.Tensor:
    """``tr(f(A))`` by SLQ on the Rademacher probe columns of ``V``."""
    nodes, weights = slq_quadrature(A, V, ncv)
    return V.shape[0] * (weights * f(nodes)).sum(-1).mean()


def slq_function_trace(
    A,
    f: Callable[[torch.Tensor], torch.Tensor],
    ncv: int = 64,
    num_repeats: int = 8,
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    """Estimate ``tr(f(A))`` for symmetric ``A`` by stochastic Lanczos
    quadrature.

    Args:
        A: Symmetric linear operator (``LinearOperator`` or a tensor).
        f: Elementwise spectral map applied to the Ritz values (torch ops).
        ncv: Lanczos steps per probe: the quadrature nodes.
        num_repeats: Number of Rademacher probes.
        generator: Draws the probes (the next default generator when ``None``).

    Returns:
        Scalar estimate of ``tr(f(A))`` (a tensor on ``A``'s device).

    Raises:
        ValueError: If ``ncv`` is not in ``(0, dim]`` or ``num_repeats`` is
            not positive.
    """
    dim = _check_square(A)
    if not 0 < ncv <= dim:
        raise ValueError(f"ncv must be in (0, {dim}], got {ncv}.")
    if num_repeats <= 0:
        raise ValueError(f"num_repeats must be positive, got {num_repeats}.")
    gen = next_default_generator(generator, A.device)
    V = rademacher(gen, (num_repeats, dim), A.dtype).to(A.device).T
    return slq_function_trace_core(A, f, V, ncv)


def slq_logdet(
    A,
    ncv: int = 64,
    num_repeats: int = 8,
    generator: torch.Generator | None = None,
    eps: float | None = None,
) -> torch.Tensor:
    """Estimate ``logdet(A) = tr(log A)`` of a symmetric positive-definite
    operator by stochastic Lanczos quadrature.

    Ritz values are clamped to ``eps`` (default: the dtype's tiny) before the
    log, so an indefinite or numerically singular operator gives large
    negative contributions rather than NaNs; damp it (``A + delta I``) for
    meaningful values near singularity.
    """
    tiny = torch.finfo(A.dtype).tiny if eps is None else eps
    return slq_function_trace(
        A, lambda t: torch.log(torch.clamp(t, min=tiny)), ncv=ncv,
        num_repeats=num_repeats, generator=generator,
    )
