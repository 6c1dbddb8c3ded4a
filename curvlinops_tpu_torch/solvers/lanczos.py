"""Lanczos spectral-density estimation (Papyan 2020), on the device.

PyTorch counterpart of ``curvlinops_tpu/solvers/lanczos.py``:

- :func:`fast_lanczos_columns` runs the recurrence without
  reorthogonalization for a fixed number of steps on the columns of a
  block, one operator matmat per step (stochastic Lanczos quadrature's
  probes); the small tridiagonal eigenproblems are one batched
  ``torch.linalg.eigh``. :func:`fast_lanczos` is its one-column case.
- Spectral boundaries come from a Lanczos run with full
  reorthogonalization (:func:`lanczos_extreme_eigenvalues`).
- Densities are one broadcast sum of Gaussian bumps.
- The ``*Cached`` classes keep Lanczos runs across hyperparameter sweeps.

The JAX package runs each fixed-length loop as one ``fori_loop`` program.
Here each recurrence, the operator's products included, runs as one
:class:`~curvlinops_tpu_torch.utils.graphs.CapturedProgram` cached on the
operator (:func:`~curvlinops_tpu_torch.ops.base.cached_program`) per number
of steps, columns and dtype: one CUDA graph, eager on the CPU. It reads
nothing to the host; the small eigenproblems of its tridiagonals run after
the replay, outside the graph (their ``info`` check reads the host). An
``A`` that is not a ``LinearOperator`` (a matrix), or one that is not
``capturable`` (a streamed or mesh curvature operator), has no program and
runs the recurrence eagerly. Start vectors come from a
``torch.Generator`` (seed 0 unless given; drawn on the generator's device,
then moved to the operator's), where the JAX package threads
``jax.random`` keys; ``v0`` passes one in directly.
"""

from __future__ import annotations

import math
import weakref
from typing import Callable

import torch

from curvlinops_tpu_torch.ops.base import LinearOperator, cached_program, program_pool
from curvlinops_tpu_torch.utils.graphs import SOLVER_REMEDY, CapturedProgram


def flat_matmat(A) -> Callable[[torch.Tensor], torch.Tensor]:
    """``mm(V) == A @ V`` on flat ``[dim, K]`` matrices (a ``LinearOperator``
    through its own tree edges, anything else through ``@``)."""
    if isinstance(A, LinearOperator):
        ravel_out, _ = A._edge("out")
        _, unravel_in = A._edge("in")
        return lambda V: ravel_out(A._matmat(unravel_in(V)))
    return lambda V: A @ V


def flat_matvec(A) -> Callable[[torch.Tensor], torch.Tensor]:
    """``mv(v) == A @ v`` on flat ``[dim]`` vectors (:func:`flat_matmat` on
    one column)."""
    mm = flat_matmat(A)
    return lambda v: mm(v[:, None])[:, 0]


def start_vector(A, generator: torch.Generator | None, shape: tuple) -> torch.Tensor:
    """Standard-normal start of ``shape`` in ``A``'s dtype, drawn from
    ``generator`` (seed 0 when ``None``) and moved to ``A``'s device."""
    gen = generator if generator is not None else torch.Generator().manual_seed(0)
    v = torch.randn(shape, generator=gen, dtype=A.dtype, device=gen.device)
    return v.to(A.device)


def _tridiagonal(alphas: torch.Tensor, betas: torch.Tensor) -> torch.Tensor:
    return torch.diag(alphas) + torch.diag(betas, 1) + torch.diag(betas, -1)


def _recurrence(A, key: tuple, make: Callable, start: torch.Tensor):
    """``make(mm)(start)`` as the program cached on ``A`` under ``key``, with
    ``mm`` :func:`flat_matmat` of ``A`` (held by a weak reference, so that
    ``A``'s cache does not keep ``A`` alive); eager for a matrix ``A`` or an
    operator that is not ``capturable``."""
    if not (isinstance(A, LinearOperator) and A.capturable):
        return make(flat_matmat(A))(start)
    ref = weakref.ref(A)
    program = cached_program(
        A, key,
        lambda: CapturedProgram(
            make(lambda V: flat_matmat(ref())(V)), start.device, f"Lanczos {key}",
            program_pool(A, start.device), SOLVER_REMEDY,
        ),
    )
    return program(start)


def fast_lanczos_recurrence(mm: Callable, ncv: int) -> Callable:
    """``V -> (alphas [R, ncv], betas [R, ncv - 1])``: ``ncv`` steps of
    Lanczos without reorthogonalization on the columns of ``V`` ``[dim, R]``,
    one product ``mm`` a step."""

    def run(V: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        tiny = torch.finfo(V.dtype).tiny
        R = V.shape[1]
        V = V / torch.linalg.vector_norm(V, dim=0)
        V_prev = torch.zeros_like(V)
        alphas = torch.zeros((R, ncv), dtype=V.dtype, device=V.device)
        betas = torch.zeros((R, max(ncv - 1, 1)), dtype=V.dtype, device=V.device)
        beta = torch.zeros(R, dtype=V.dtype, device=V.device)
        for m in range(ncv):
            W = mm(V) - beta * V_prev
            alpha = (W * V).sum(0)
            alphas[:, m] = alpha
            W = W - alpha * V
            beta = torch.linalg.vector_norm(W, dim=0)
            if m < ncv - 1:
                betas[:, m] = beta
            V_prev, V = V, W / torch.clamp(beta, min=tiny)
        return alphas, betas[:, : ncv - 1]

    return run


def fast_lanczos_columns(A, V: torch.Tensor, ncv: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Lanczos without reorthogonalization on every column of ``V``
    ``[dim, R]`` at once, ``ncv`` steps: each step is one operator matmat
    over the ``R`` columns (the recurrence is one cached program,
    :func:`fast_lanczos_recurrence`), and the ``R`` tridiagonals are
    eigendecomposed in one batched ``eigh`` in float64 (``[R, ncv, ncv]``: a
    float32 ``eigh`` would blur the small Ritz values by the largest one's
    roundoff), its results cast back to ``V``'s dtype.

    Returns:
        ``(evals [R, ncv], evecs [R, ncv, ncv])``.
    """
    alphas, off = _recurrence(
        A, ("fast_lanczos", ncv, V.shape[1], V.dtype),
        lambda mm: fast_lanczos_recurrence(mm, ncv), V,
    )
    T = torch.diag_embed(alphas) + torch.diag_embed(off, 1) + torch.diag_embed(off, -1)
    evals, evecs = torch.linalg.eigh(T.double())
    return evals.to(V.dtype), evecs.to(V.dtype)


def fast_lanczos(
    A, ncv: int, generator: torch.Generator | None = None, v0: torch.Tensor | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Lanczos without reorthogonalization; eigendecomposed tridiagonal.

    Args:
        A: Symmetric linear operator (flat ``[dim]`` vectors).
        ncv: Number of Lanczos vectors.
        generator: Draws the random start vector (ignored with ``v0``).
        v0: Start vector ``[dim]``.

    Returns:
        ``(evals [ncv], evecs [ncv, ncv])`` of the tridiagonal matrix.
    """
    v = v0 if v0 is not None else start_vector(A, generator, (A.shape[1],))
    evals, evecs = fast_lanczos_columns(A, v[:, None], ncv)
    return evals[0], evecs[0]


def reorthogonalized_lanczos(
    A,
    num_iters: int = 32,
    generator: torch.Generator | None = None,
    power: int = 1,
    v0: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Lanczos with full reorthogonalization on ``A^power``.

    Returns:
        ``(V, T)``: the orthonormal basis ``[ncv, dim]`` (rows) and the
        tridiagonal ``[ncv, ncv]``, ``ncv = min(num_iters, dim)``, on
        ``A``'s device. ``T[0, 0]`` is the start vector's Rayleigh quotient;
        an eigenpair ``(theta, s)`` of ``T`` gives the Ritz pair
        ``(theta, V^T s)``.
    """
    ncv = min(num_iters, A.shape[1])
    v = v0 if v0 is not None else start_vector(A, generator, (A.shape[1],))
    return _recurrence(
        A, ("lanczos_extreme", ncv, power, v.dtype),
        lambda mm: reorthogonalized_recurrence(mm, ncv, power), v,
    )


def reorthogonalized_recurrence(mm: Callable, ncv: int, power: int = 1) -> Callable:
    """``v -> (V [ncv, dim], T [ncv, ncv])``: ``ncv`` steps of Lanczos with
    full reorthogonalization on ``A^power`` from ``v`` ``[dim]``, ``power``
    products ``mm`` (on ``[dim, 1]`` columns) a step."""

    def mv(x: torch.Tensor) -> torch.Tensor:
        for _ in range(power):
            x = mm(x[:, None])[:, 0]
        return x

    def run(v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        tiny = torch.finfo(v.dtype).tiny
        v = v / torch.linalg.vector_norm(v)
        V = torch.zeros((ncv, v.shape[0]), dtype=v.dtype, device=v.device)
        alphas = torch.zeros(ncv, dtype=v.dtype, device=v.device)
        betas = torch.zeros(ncv, dtype=v.dtype, device=v.device)
        for m in range(ncv):
            V[m] = v
            w = mv(v)
            alphas[m] = torch.dot(w, v)
            # full reorthogonalization against the stored basis, twice
            w = w - V.T @ (V @ w)
            w = w - V.T @ (V @ w)
            betas[m] = beta = torch.linalg.vector_norm(w)
            v = w / torch.clamp(beta, min=tiny)
        return V, _tridiagonal(alphas, betas[: ncv - 1])

    return run


def lanczos_extreme_eigenvalues(
    A,
    num_iters: int = 32,
    generator: torch.Generator | None = None,
    power: int = 1,
    v0: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Extremal eigenvalue estimates by Lanczos with full reorthogonalization
    (:func:`reorthogonalized_lanczos`).

    ``power=2`` runs the recurrence on ``A^2`` (two operator applications
    per step): its extremal Ritz values estimate the squared largest- and
    smallest-magnitude eigenvalues of ``A``.

    Returns:
        ``(lambda_min, lambda_max)`` estimates (of ``A^power``), 0-d tensors
        on ``A``'s device.
    """
    _, T = reorthogonalized_lanczos(A, num_iters, generator, power, v0)
    ritz = torch.linalg.eigvalsh(T)
    return ritz[0], ritz[-1]


def _num_iters(tol: float) -> int:
    """The Lanczos steps for a relative accuracy ``tol``."""
    return max(8, int(4 / math.sqrt(tol)))


def lanczos_eigsh(A, which: str = "BE", tol: float = 1e-2, generator: torch.Generator | None = None):
    """``eigsh``-style extremal-eigenvalue selector, on the device.

    - ``"BE"``: both ends, ``(lambda_min, lambda_max)`` (signed).
    - ``"SA"`` / ``"LA"``: smallest / largest algebraic eigenvalue.
    - ``"LM"`` / ``"SM"``: largest / smallest magnitude, returned as the
      magnitude, from Lanczos on ``A^2``.

    Args:
        A: Symmetric linear operator (flat ``[dim]`` vectors).
        which: One of ``{"BE", "SA", "LA", "LM", "SM"}``.
        tol: Relative accuracy; sets the Lanczos iteration count.
        generator: Draws the start vector.

    Returns:
        ``(lambda_min, lambda_max)`` for ``"BE"``; one float otherwise.

    Raises:
        ValueError: For an unknown selector.
    """
    num_iters = _num_iters(tol)
    if which in ("BE", "SA", "LA"):
        lo, hi = lanczos_extreme_eigenvalues(A, num_iters=num_iters, generator=generator)
        if which == "BE":
            return float(lo), float(hi)
        return float(lo) if which == "SA" else float(hi)
    if which in ("LM", "SM"):
        lo2, hi2 = lanczos_extreme_eigenvalues(
            A, num_iters=num_iters, generator=generator, power=2
        )
        return math.sqrt(max(float(lo2 if which == "SM" else hi2), 0.0))
    raise ValueError(f"Unknown selector which={which!r}; expected BE, SA, LA, LM, or SM.")


def _fill_in(estimate: tuple[float, float], boundaries) -> tuple[float, float]:
    """Given boundaries override the estimated ones where not ``None``."""
    if boundaries is None:
        return estimate
    return tuple(e if b is None else b for e, b in zip(estimate, boundaries))


def approximate_boundaries(
    A, tol: float = 1e-2, boundaries=None, generator: torch.Generator | None = None
) -> tuple[float, float]:
    """Estimate ``(lambda_min, lambda_max)`` of a symmetric operator."""
    if boundaries is not None and None not in boundaries:
        return boundaries
    return _fill_in(lanczos_eigsh(A, which="BE", tol=tol, generator=generator), boundaries)


def approximate_boundaries_abs(
    A, tol: float = 1e-2, boundaries=None, generator: torch.Generator | None = None
) -> tuple[float, float]:
    """Estimate ``(lambda_min, lambda_max)`` of ``|A|``.

    Lanczos on ``A^2``: its extremal Ritz values estimate the squared
    largest- and smallest-magnitude eigenvalues of ``A``. (The smaller of
    the signed extremes' magnitudes would be wrong for a spectrum that
    straddles zero, whose ``lambda_min(|A|)`` is near 0.)
    """
    if boundaries is not None and None not in boundaries:
        return boundaries
    lo2, hi2 = lanczos_extreme_eigenvalues(
        A, num_iters=_num_iters(tol), generator=generator, power=2
    )
    estimate = (math.sqrt(max(float(lo2), 0.0)), math.sqrt(max(float(hi2), 0.0)))
    return _fill_in(estimate, boundaries)


def _gaussian_density(
    nodes: torch.Tensor, weights: torch.Tensor, grid: torch.Tensor, sigma: float
) -> torch.Tensor:
    """Sum of Gaussian bumps at ``nodes`` with ``weights`` over ``grid``."""
    z = (grid[None, :] - nodes[:, None]) / sigma
    bumps = torch.exp(-0.5 * z**2) / (sigma * math.sqrt(2 * math.pi))
    return (weights[:, None] * bumps).sum(0)


def _sigma(ncv: int, kappa: float) -> float:
    return 2 / (ncv - 1) / math.sqrt(8 * math.log(kappa))


def lanczos_approximate_spectrum_from_iter(
    lanczos_iter, boundaries, num_points: int, kappa: float, margin: float
):
    """Density from one Lanczos run (Papyan 2020)."""
    eval_min, eval_max = boundaries
    padding = margin * (eval_max - eval_min)
    eval_min, eval_max = eval_min - padding, eval_max + padding
    c, d = (eval_max + eval_min) / 2, (eval_max - eval_min) / 2

    evals, evecs = lanczos_iter
    kw = dict(dtype=evals.dtype, device=evals.device)
    grid_norm = torch.linspace(-1.0, 1.0, num_points, **kw)
    density = _gaussian_density(
        (evals - c) / d, evecs[0, :] ** 2 / d, grid_norm, _sigma(evals.shape[0], kappa)
    )
    return torch.linspace(eval_min, eval_max, num_points, **kw), density


def lanczos_approximate_log_spectrum_from_iter(
    lanczos_iter, boundaries, num_points: int, kappa: float, margin: float, epsilon: float
):
    """Log-spectrum density from one Lanczos run (Papyan 2020)."""
    log_min, log_max = (math.log(b + epsilon) for b in boundaries)
    padding = margin * (log_max - log_min)
    log_min, log_max = log_min - padding, log_max + padding
    c, d = (log_max + log_min) / 2, (log_max - log_min) / 2

    evals, evecs = lanczos_iter
    grid_norm = torch.linspace(-1.0, 1.0, num_points, dtype=evals.dtype, device=evals.device)
    grid_out = torch.exp(grid_norm * d + c)
    nodes = (torch.log(evals.abs() + epsilon) - c) / d
    density = _gaussian_density(
        nodes, evecs[0, :] ** 2, grid_norm, _sigma(evals.shape[0], kappa)
    ) / (d * grid_out)
    return grid_out, density


def _running_mean(densities) -> torch.Tensor:
    """The running average of densities, updated as the JAX package does."""
    avg = None
    for n, density in enumerate(densities):
        avg = density if avg is None else (1 - 1 / (n + 1)) * avg + density / (n + 1)
    return avg


def lanczos_approximate_spectrum(
    A,
    ncv: int,
    num_points: int = 1024,
    num_repeats: int = 1,
    kappa: float = 3.0,
    boundaries=None,
    margin: float = 0.05,
    boundaries_tol: float = 1e-2,
    generator: torch.Generator | None = None,
):
    """Approximate the spectral density of a symmetric operator (Papyan 2020,
    Algorithm 2). The boundaries' start vector and then each repeat's come
    from ``generator`` in turn."""
    gen = generator if generator is not None else torch.Generator().manual_seed(0)
    boundaries = approximate_boundaries(A, boundaries_tol, boundaries, gen)
    results = [
        lanczos_approximate_spectrum_from_iter(
            fast_lanczos(A, ncv, generator=gen), boundaries, num_points, kappa, margin
        )
        for _ in range(num_repeats)
    ]
    return results[-1][0], _running_mean(d for _, d in results)


def lanczos_approximate_log_spectrum(
    A,
    ncv: int,
    num_points: int = 1024,
    num_repeats: int = 1,
    kappa: float = 1.04,
    boundaries=None,
    margin: float = 0.05,
    boundaries_tol: float = 1e-2,
    epsilon: float = 1e-5,
    generator: torch.Generator | None = None,
):
    """Approximate the spectral density of ``log(|A| + eps I)``."""
    gen = generator if generator is not None else torch.Generator().manual_seed(0)
    boundaries = approximate_boundaries_abs(A, boundaries_tol, boundaries, gen)
    results = [
        lanczos_approximate_log_spectrum_from_iter(
            fast_lanczos(A, ncv, generator=gen), boundaries, num_points, kappa, margin, epsilon
        )
        for _ in range(num_repeats)
    ]
    return results[-1][0], _running_mean(d for _, d in results)


class _LanczosSpectrumCached:
    """Keeps Lanczos runs across hyperparameter sweeps: the ``n``-th run is
    drawn once, in order, from the instance's generator."""

    def __init__(self, A, ncv: int, generator: torch.Generator | None = None):
        self._A, self._ncv = A, ncv
        self._gen = generator if generator is not None else torch.Generator().manual_seed(0)
        self._iters: list = []

    def _ensure_iters(self, num_repeats: int) -> None:
        while len(self._iters) < num_repeats:
            self._iters.append(fast_lanczos(self._A, self._ncv, generator=self._gen))


class LanczosApproximateSpectrumCached(_LanczosSpectrumCached):
    """Spectrum approximator reusing cached Lanczos iterations."""

    def __init__(
        self, A, ncv: int, boundaries=None, boundaries_tol: float = 1e-2,
        generator: torch.Generator | None = None,
    ):
        super().__init__(A, ncv, generator)
        self._boundaries = approximate_boundaries(A, boundaries_tol, boundaries, self._gen)

    def approximate_spectrum(
        self, num_repeats: int = 1, num_points: int = 1024, kappa: float = 3.0,
        margin: float = 0.05,
    ):
        """Density averaged over (cached) Lanczos repeats."""
        self._ensure_iters(num_repeats)
        results = [
            lanczos_approximate_spectrum_from_iter(
                it, self._boundaries, num_points, kappa, margin
            )
            for it in self._iters[:num_repeats]
        ]
        return results[-1][0], _running_mean(d for _, d in results)


class LanczosApproximateLogSpectrumCached(_LanczosSpectrumCached):
    """Log-spectrum approximator reusing cached Lanczos iterations."""

    def __init__(
        self, A, ncv: int, boundaries=None, boundaries_tol: float = 1e-2,
        generator: torch.Generator | None = None,
    ):
        super().__init__(A, ncv, generator)
        self._boundaries = approximate_boundaries_abs(A, boundaries_tol, boundaries, self._gen)

    def approximate_log_spectrum(
        self, num_repeats: int = 1, num_points: int = 1024, kappa: float = 1.04,
        margin: float = 0.05, epsilon: float = 1e-5,
    ):
        """Log-density averaged over (cached) Lanczos repeats."""
        self._ensure_iters(num_repeats)
        results = [
            lanczos_approximate_log_spectrum_from_iter(
                it, self._boundaries, num_points, kappa, margin, epsilon
            )
            for it in self._iters[:num_repeats]
        ]
        return results[-1][0], _running_mean(d for _, d in results)
