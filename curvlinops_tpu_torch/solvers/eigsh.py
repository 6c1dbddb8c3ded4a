"""Top-k eigenpairs by LOBPCG and the smallest eigenvalue by Lanczos, on the device.

PyTorch counterpart of ``curvlinops_tpu/solvers/eigsh.py``. The JAX package
calls ``jax.experimental.sparse.linalg.lobpcg_standard``; PyTorch's
``torch.lobpcg`` is a different algorithm with its own conventions, so
:func:`lobpcg_standard` here follows JAX's: the same orthonormal block
``[X, P, R]``, the same Rayleigh-Ritz step, the same basis truncation
(SVQB, projection "twice is enough") and the same ``m`` / ``tol``
semantics. It applies the operator at widths 1 (the input check), k and
3k. Its iteration is a step function driven by a loop of
:mod:`curvlinops_tpu_torch.utils.graphs`: eagerly, one host read of the
flag "fewer than k pairs converged" an iteration, or, in
:func:`topk_eigenpairs` over a ``capturable`` operator (the counterpart of
JAX's ``jit="auto"``), as a captured chunk of masked iterations cached on
the operator, one host read a chunk. Its small symmetric eigenproblems go
through :func:`~curvlinops_tpu_torch.solvers.small_eigh.small_eigh`, a
kernel that reads nothing to the host (``torch.linalg.eigh`` does), while
the ``[3k, 3k]`` Rayleigh-Ritz matrix is within the kernel's size limit;
past it through ``torch.linalg.eigh``, eagerly (:func:`lobpcg_eigh`, the
one place that chooses). ``torch.linalg.qr`` of the ``[2k, k]`` block reads
nothing either and is captured as it is. The start (the input check, the
orthonormalization, the SVD that extends the basis, the first product) runs
eagerly.
"""

from __future__ import annotations

import weakref
from typing import Callable

import torch

from curvlinops_tpu_torch.ops.base import LinearOperator, cached_program, program_pool
from curvlinops_tpu_torch.solvers.lanczos import (
    flat_matmat,
    lanczos_extreme_eigenvalues,
    start_vector,
)
from curvlinops_tpu_torch.solvers import small_eigh as _small_eigh
from curvlinops_tpu_torch.solvers.small_eigh import small_eigh, small_eigh_plain
from curvlinops_tpu_torch.utils.graphs import ChunkedLoop, EagerLoop

# the way out named when LOBPCG's program cannot be captured
LOBPCG_REMEDY = "pass `capture=False` to `topk_eigenpairs` to run LOBPCG eagerly"
Eigh = Callable[[torch.Tensor], "tuple[torch.Tensor, torch.Tensor]"]


def lobpcg_eigh(k: int) -> Eigh:
    """LOBPCG's small symmetric eigensolver at block size ``k`` (eigenvalues
    descending): the small-eigh kernel while the ``[3k, 3k]`` Rayleigh-Ritz
    matrix is within its limit (``3k <= small_eigh.MAX_N``), for every small
    problem of the run, so that eager and captured runs share one arithmetic;
    past it ``torch.linalg.eigh``, which reads the host, so such a run is
    not captured (:func:`topk_eigenpairs`)."""
    return small_eigh if 3 * k <= _small_eigh.MAX_N else small_eigh_plain


def _col_norms(X: torch.Tensor) -> torch.Tensor:
    """Column norms ``[1, K]``, summed in float64: PyTorch's CPU reduction
    down the long axis of a float32 ``[n, K]`` sums in order, 2.9e-5
    relative at n = 200,000, and LOBPCG normalizes every basis by these."""
    return torch.linalg.vector_norm(X, dim=0, keepdim=True, dtype=torch.float64).to(X.dtype)


def _svqb(X: torch.Tensor, eigh: Eigh) -> torch.Tensor:
    """A truncated orthonormal basis of ``X`` (SVQB): directions whose Gram
    eigenvalue is below ``eps`` times the largest come back as zero columns."""
    norms = _col_norms(X)
    X = X / torch.where(norms == 0, 1.0, norms)
    inner = X.T @ X
    w, V = eigh(inner)
    tau = torch.finfo(X.dtype).eps * w[0]
    padded = torch.maximum(w, tau)
    sqrted = torch.where(tau > 0, padded, 1.0) ** -0.5
    orthoX = X @ (V * sqrted[None, :])
    keep = ((w > tau) & (torch.diagonal(inner) > 0.0))[None, :]
    orthoX = orthoX * keep
    norms = _col_norms(orthoX)
    keep = keep & (norms > 0.0)
    return orthoX / torch.where(keep, norms, 1.0)


def _orthonormalize(basis: torch.Tensor, eigh: Eigh) -> torch.Tensor:
    for _ in range(2):  # twice is enough
        basis = _svqb(basis, eigh)
    return basis


def _project_out(basis: torch.Tensor, U: torch.Tensor, eigh: Eigh) -> torch.Tensor:
    """The part of ``U`` orthogonal to the orthonormal (zero columns
    allowed) ``basis``, orthonormalized; suspicious columns are zeroed, and
    the last step is a subtraction of the basis."""
    for _ in range(2):
        U = U - basis @ (basis.T @ U)
        U = _orthonormalize(U, eigh)
    for _ in range(2):
        U = U - basis @ (basis.T @ U)
    return U * (_col_norms(U) >= 0.99)


def _extend_basis(X: torch.Tensor, m: int) -> torch.Tensor:
    """``m`` orthonormal directions orthogonal to the orthonormal ``X``, by
    a block Householder reflector (deterministic, no random basis)."""
    n, k = X.shape
    Xupper, Xlower = X[:k], X[k:]
    u, s, vt = torch.linalg.svd(Xupper)
    y = torch.cat([Xupper + u @ vt, Xlower])
    other = torch.cat([
        torch.eye(m, dtype=X.dtype, device=X.device),
        torch.zeros((n - k - m, m), dtype=X.dtype, device=X.device),
    ])
    w = y @ (vt.T * ((2 * (1 + s)) ** -0.5)[None, :])
    h = -2 * torch.linalg.multi_dot([w, w[k:, :].T, other])
    h[k:] += other
    return h


def _check_inputs(A: Callable, X: torch.Tensor) -> None:
    n, k = X.shape
    if k == 0:
        raise ValueError(f"must have search dim > 0, got {k}")
    if k * 5 >= n:
        raise ValueError(f"expected search dim * 5 < matrix dim (got {k * 5}, {n})")
    out = A(torch.zeros((n, 1), dtype=X.dtype, device=X.device))
    if out.dtype != X.dtype:
        raise ValueError(f"A, X must have same dtypes (were {out.dtype}, {X.dtype})")
    if tuple(out.shape) != (n, 1):
        raise ValueError(f"A must be ({n}, {n}) matrix A, got output {tuple(out.shape)}")


def lobpcg_step(matmat: Callable, n: int, k: int, tol: float, eigh: Eigh) -> Callable:
    """One LOBPCG iteration on the state ``(X, P, R, theta)``, as a loop
    step (no constants); it goes on while fewer than ``k`` pairs have
    converged. ``eigh`` solves the small symmetric problems
    (:func:`lobpcg_eigh`)."""

    def step(i, state: tuple, consts: tuple) -> tuple:
        X, P, R, _ = state
        R = _project_out(torch.cat([X, P], dim=1), R, eigh)
        XPR = torch.cat([X, P, R], dim=1)
        # Rayleigh-Ritz on the orthonormal (zero columns allowed) XPR
        theta_all, Q = eigh(XPR.T @ matmat(XPR))

        B = Q[:, :k]
        B = B / _col_norms(B)
        X = XPR @ B
        X = X / _col_norms(X)

        # the difference directions: [0; Q[k:, :k]] orthogonalized against
        # Q[:, :k] in the standard basis, then mapped by XPR
        q, _ = torch.linalg.qr(Q[:k, k:].T)
        P = XPR @ (Q[:, k:] @ q)
        normP = _col_norms(P)
        P = P / torch.where(normP == 0, 1.0, normP)

        AX = matmat(X)
        theta = theta_all[None, :k]
        R = AX - theta * X
        reltol = (torch.linalg.vector_norm(AX, dim=0) + theta_all[:k]) * n * 10
        converged = (torch.linalg.vector_norm(R, dim=0) < tol * reltol).sum()
        return (X, P, R, theta), converged < k

    return step


def lobpcg_standard(
    A: torch.Tensor | Callable[[torch.Tensor], torch.Tensor],
    X: torch.Tensor,
    m: int = 100,
    tol: float | None = None,
    loop: ChunkedLoop | EagerLoop | None = None,
) -> tuple[torch.Tensor, torch.Tensor, int]:
    """Top-k eigenpairs of a symmetric ``A`` by LOBPCG, as JAX's
    ``lobpcg_standard``.

    Args:
        A: An ``[n, n]`` symmetric matrix, or its action on ``[n, K]``.
        X: ``[n, k]`` start directions (orthonormalized here), ``5k < n``.
        m: Iteration cap.
        tol: A pair converges when ``||A v - lambda v|| < tol * 10 n
            (lambda + ||A v||)``; the dtype's ``eps`` when ``None``.
        loop: Drives the iterations (an :class:`EagerLoop` when ``None``).
            A captured loop needs the small-eigh kernel, so ``3k`` within
            its limit (:func:`lobpcg_eigh`).

    Returns:
        ``(theta [k], U [n, k], iterations)``, the eigenvalues in
        descending order.

    Raises:
        ValueError: On a bad ``k`` or mismatching ``A``.
    """
    matmat = (lambda V: A @ V) if isinstance(A, torch.Tensor) else A
    n, k = X.shape
    _check_inputs(matmat, X)
    if tol is None:
        tol = torch.finfo(X.dtype).eps

    eigh = lobpcg_eigh(k)
    X = _orthonormalize(X, eigh)
    P = _extend_basis(X, k)
    AX = matmat(X)
    theta = (X * AX).sum(0, keepdim=True)
    R = AX - theta * X
    loop = EagerLoop() if loop is None else loop
    running = torch.ones((), dtype=torch.bool, device=X.device)  # no pair converged yet
    (X, _, _, theta), i, _ = loop(lobpcg_step(matmat, n, k, tol, eigh), m, (X, P, R, theta),
                                  (), running)
    return theta[0], X, i


def topk_eigenpairs(
    A,
    k: int,
    *,
    maxiter: int = 100,
    tol: float | None = None,
    generator: torch.Generator | None = None,
    X0: torch.Tensor | None = None,
    capture: bool | str = "auto",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Largest-``k`` eigenpairs of a symmetric PSD operator by LOBPCG.

    Args:
        A: Symmetric operator on flat vectors (``A @ X`` for ``[dim, K]``).
        k: Number of eigenpairs.
        maxiter: LOBPCG iteration cap.
        tol: Residual tolerance (the dtype's ``eps`` when ``None``).
        generator: Draws the ``[dim, k]`` start block (ignored with ``X0``).
        X0: Start block ``[dim, k]``.
        capture: Run the iterations as a captured program cached on ``A``
            (under ``("lobpcg", k, maxiter, tol, dtype)``; the counterpart of
            JAX's ``jit``): ``"auto"`` whenever ``A`` is a ``capturable``
            :class:`~curvlinops_tpu_torch.ops.base.LinearOperator` and ``k``
            is within the small-eigh kernel's limit, ``True`` requires both,
            ``False`` runs the eager loop.

    The small eigenproblems' route, chosen once for the run by ``k``
    (:func:`lobpcg_eigh`; JAX's takes any ``k`` with ``5k < dim``):

    - ``3k <= 512`` (``small_eigh.MAX_N``): the ``[3k, 3k]`` Rayleigh-Ritz
      and ``[k, k]`` Gram problems go through the small-eigh kernel on the
      card, in the start, the eager loop and the captured loop alike;
    - ``3k > 512``: they go through ``torch.linalg.eigh``, which reads the
      host, so the loop runs eagerly: ``capture="auto"`` runs it eagerly and
      ``capture=True`` raises.

    On the CPU both routes compute ``torch.linalg.eigh``.

    Returns:
        ``(eigenvalues [k] descending, eigenvectors [dim, k])``.

    Raises:
        ValueError: If ``capture=True`` and ``A`` is not a ``capturable``
            operator, or ``3k`` is past the kernel's limit.
    """
    X = X0 if X0 is not None else start_vector(A, generator, (A.shape[0], k))
    can = isinstance(A, LinearOperator) and A.capturable
    if capture is True and not can:
        raise ValueError("capture=True needs a `capturable` LinearOperator.")
    if lobpcg_eigh(k) is small_eigh_plain:
        if capture is True:
            raise ValueError(
                f"capture=True: LOBPCG at k={k} solves [{3 * k}, {3 * k}] Rayleigh-Ritz "
                f"problems, past the small-eigh kernel's limit of {_small_eigh.MAX_N} "
                f"(3k <= {_small_eigh.MAX_N}), and torch.linalg.eigh cannot be captured; "
                f"{LOBPCG_REMEDY}.")
        can = False
    loop = None
    matmat = lambda V: A @ V  # noqa: E731
    if can and capture:
        ref = weakref.ref(A)  # A's cache holds the loop: no cycle through it
        matmat = lambda V: flat_matmat(ref())(V)  # noqa: E731
        loop = cached_program(
            A, ("lobpcg", k, maxiter, tol, X.dtype),
            lambda: ChunkedLoop(X.device, "LOBPCG", program_pool(A, X.device), LOBPCG_REMEDY),
        )
    evals, evecs, _ = lobpcg_standard(matmat, X, m=maxiter, tol=tol, loop=loop)
    order = torch.argsort(evals, descending=True)
    return evals[order], evecs[:, order]


def smallest_eigenvalue(
    A, *, num_iters: int = 64, generator: torch.Generator | None = None
) -> torch.Tensor:
    """Smallest eigenvalue estimate by reorthogonalized Lanczos."""
    lo, _ = lanczos_extreme_eigenvalues(A, num_iters=num_iters, generator=generator)
    return lo
