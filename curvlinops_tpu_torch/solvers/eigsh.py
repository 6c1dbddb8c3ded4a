"""Top-k eigenpairs by LOBPCG and the smallest eigenvalue by Lanczos, on the device.

PyTorch counterpart of ``curvlinops_tpu/solvers/eigsh.py``. The JAX package
calls ``jax.experimental.sparse.linalg.lobpcg_standard``; PyTorch's
``torch.lobpcg`` is a different algorithm with its own conventions, so
:func:`lobpcg_standard` here follows JAX's: the same orthonormal block
``[X, P, R]``, the same Rayleigh-Ritz step, the same basis truncation
(SVQB, projection "twice is enough") and the same ``m`` / ``tol``
semantics. It applies the operator at widths 1 (the input check), k and
3k. The loop reads one integer per iteration to the host: the number of
converged pairs.
"""

from __future__ import annotations

from typing import Callable

import torch

from curvlinops_tpu_torch.solvers.lanczos import lanczos_extreme_eigenvalues, start_vector


def _col_norms(X: torch.Tensor) -> torch.Tensor:
    """Column norms ``[1, K]``, summed in float64: PyTorch's CPU reduction
    down the long axis of a float32 ``[n, K]`` sums in order, 2.9e-5
    relative at n = 200,000, and LOBPCG normalizes every basis by these."""
    return torch.linalg.vector_norm(X, dim=0, keepdim=True, dtype=torch.float64).to(X.dtype)


def _eigh_descending(A: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    w, V = torch.linalg.eigh(A)
    return w.flip(0), V.flip(1)


def _svqb(X: torch.Tensor) -> torch.Tensor:
    """A truncated orthonormal basis of ``X`` (SVQB): directions whose Gram
    eigenvalue is below ``eps`` times the largest come back as zero columns."""
    norms = _col_norms(X)
    X = X / torch.where(norms == 0, 1.0, norms)
    inner = X.T @ X
    w, V = _eigh_descending(inner)
    tau = torch.finfo(X.dtype).eps * w[0]
    padded = torch.maximum(w, tau)
    sqrted = torch.where(tau > 0, padded, 1.0) ** -0.5
    orthoX = X @ (V * sqrted[None, :])
    keep = ((w > tau) & (torch.diagonal(inner) > 0.0))[None, :]
    orthoX = orthoX * keep
    norms = _col_norms(orthoX)
    keep = keep & (norms > 0.0)
    return orthoX / torch.where(keep, norms, 1.0)


def _orthonormalize(basis: torch.Tensor) -> torch.Tensor:
    for _ in range(2):  # twice is enough
        basis = _svqb(basis)
    return basis


def _project_out(basis: torch.Tensor, U: torch.Tensor) -> torch.Tensor:
    """The part of ``U`` orthogonal to the orthonormal (zero columns
    allowed) ``basis``, orthonormalized; suspicious columns are zeroed, and
    the last step is a subtraction of the basis."""
    for _ in range(2):
        U = U - basis @ (basis.T @ U)
        U = _orthonormalize(U)
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


def lobpcg_standard(
    A: torch.Tensor | Callable[[torch.Tensor], torch.Tensor],
    X: torch.Tensor,
    m: int = 100,
    tol: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor, int]:
    """Top-k eigenpairs of a symmetric ``A`` by LOBPCG, as JAX's
    ``lobpcg_standard``.

    Args:
        A: An ``[n, n]`` symmetric matrix, or its action on ``[n, K]``.
        X: ``[n, k]`` start directions (orthonormalized here), ``5k < n``.
        m: Iteration cap.
        tol: A pair converges when ``||A v - lambda v|| < tol * 10 n
            (lambda + ||A v||)``; the dtype's ``eps`` when ``None``.

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

    X = _orthonormalize(X)
    P = _extend_basis(X, k)
    AX = matmat(X)
    theta = (X * AX).sum(0, keepdim=True)
    R = AX - theta * X
    i, converged = 0, 0
    # the loop's one host read per iteration: the count of converged pairs
    while i < m and converged < k:
        R = _project_out(torch.cat([X, P], dim=1), R)
        XPR = torch.cat([X, P, R], dim=1)
        # Rayleigh-Ritz on the orthonormal (zero columns allowed) XPR
        theta_all, Q = _eigh_descending(XPR.T @ matmat(XPR))

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
        converged = int((torch.linalg.vector_norm(R, dim=0) < tol * reltol).sum())
        i += 1
    return theta[0], X, i


def topk_eigenpairs(
    A,
    k: int,
    *,
    maxiter: int = 100,
    tol: float | None = None,
    generator: torch.Generator | None = None,
    X0: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Largest-``k`` eigenpairs of a symmetric PSD operator by LOBPCG.

    Args:
        A: Symmetric operator on flat vectors (``A @ X`` for ``[dim, K]``).
        k: Number of eigenpairs.
        maxiter: LOBPCG iteration cap.
        tol: Residual tolerance (the dtype's ``eps`` when ``None``).
        generator: Draws the ``[dim, k]`` start block (ignored with ``X0``).
        X0: Start block ``[dim, k]``.

    Returns:
        ``(eigenvalues [k] descending, eigenvectors [dim, k])``.
    """
    X = X0 if X0 is not None else start_vector(A, generator, (A.shape[0], k))
    evals, evecs, _ = lobpcg_standard(lambda V: A @ V, X, m=maxiter, tol=tol)
    order = torch.argsort(evals, descending=True)
    return evals[order], evecs[:, order]


def smallest_eigenvalue(
    A, *, num_iters: int = 64, generator: torch.Generator | None = None
) -> torch.Tensor:
    """Smallest eigenvalue estimate by reorthogonalized Lanczos."""
    lo, _ = lanczos_extreme_eigenvalues(A, num_iters=num_iters, generator=generator)
    return lo
