"""Inverse linear operators: CG, MINRES, LSMR and truncated Neumann series.

PyTorch counterpart of ``curvlinops_tpu/ops/inverse.py``. The iterations
run on the device (:mod:`curvlinops_tpu_torch.solvers`). Where the JAX
package compiles each Krylov solve (CG, MINRES, LSMR) into one XLA
program, here a solve over ``capturable`` operators (``A``, the
preconditioner, ``A``'s adjoint for LSMR) runs as one cached
:class:`~curvlinops_tpu_torch.utils.graphs.ChunkedLoop` per number of
columns, hyperparameters and dtype: a captured chunk of masked iterations,
replayed with one host read a chunk; over any other operator the solve runs
eagerly, reading its stopping flag once an iteration. Each solve's ``info``
adds ``host_reads``, the flag reads it made. The Neumann series reads
nothing until its end: over ``capturable`` operators the whole series runs
as one cached :class:`~curvlinops_tpu_torch.utils.graphs.CapturedProgram`
(the JAX package's ``fori_loop`` program), and its divergence flag is read
once, after the replay. ``set_*_hyperparameters`` changes the next solve
and drops the cached programs
(:meth:`~curvlinops_tpu_torch.ops.base.LinearOperator.invalidate_traced`).

Example:
    >>> import torch
    >>> from curvlinops_tpu_torch.ops.dense import MatrixLinearOperator
    >>> from curvlinops_tpu_torch.ops.inverse import CGInverseLinearOperator
    >>> M = torch.randn(6, 6, generator=torch.Generator().manual_seed(0)) / 6
    >>> A = MatrixLinearOperator(M @ M.T + torch.eye(6))  # SPD
    >>> v = torch.ones(6)
    >>> x = CGInverseLinearOperator(A, maxiter=50, tol=1e-9) @ v
    >>> bool(torch.allclose(A @ x, v, atol=1e-4))
    True
"""

from __future__ import annotations

from typing import Any, Callable

import torch
from torch.utils import _pytree as pytree

from curvlinops_tpu_torch.ops.base import LinearOperator, cached_program, program_pool
from curvlinops_tpu_torch.solvers.cg import batched_cg, flatten_columns, on_flat
from curvlinops_tpu_torch.solvers.lsmr import batched_lsmr
from curvlinops_tpu_torch.solvers.minres import batched_minres
from curvlinops_tpu_torch.utils.graphs import (
    SOLVER_REMEDY,
    CapturedProgram,
    ChunkedLoop,
    EagerLoop,
)


def _set(op: LinearOperator, names: tuple, kwargs: dict, solver: str) -> None:
    """Set the named hyperparameters ``op._<name>`` and drop the cached
    programs; refuse unknown names."""
    for name in names:
        if name in kwargs:
            setattr(op, f"_{name}", kwargs.pop(name))
    if kwargs:
        raise ValueError(f"Unknown {solver} hyperparameters: {sorted(kwargs)}.")
    op.invalidate_traced()


def _loop(op: LinearOperator, M: Any, key: tuple, operators: tuple, name: str):
    """The solve's loop: the :class:`ChunkedLoop` cached on ``op`` under
    ``key`` + ``(ncols, dtype)`` when every operator of ``operators`` is
    ``capturable``, else a fresh :class:`EagerLoop`."""
    if not all(A is None or A.capturable for A in operators):
        return EagerLoop()
    leaf = pytree.tree_leaves(M)[0]
    return cached_program(
        op, (*key, leaf.shape[-1], leaf.dtype),
        lambda: ChunkedLoop(op.device, name, program_pool(op, op.device)),
    )


def _require_square(A: LinearOperator) -> None:
    if A.shape[0] != A.shape[1]:
        raise ValueError(f"Operator must be square, got {A.shape}.")


class CGInverseLinearOperator(LinearOperator):
    """``A^{-1}`` by batched (preconditioned) conjugate gradients."""

    def __init__(
        self,
        A: LinearOperator,
        *,
        maxiter: int = 100,
        tol: float = 1e-5,
        atol: float = 1e-8,
        preconditioner: LinearOperator | None = None,
    ):
        _require_square(A)
        super().__init__(A.in_spec, A.out_spec)
        self._A = A
        self._maxiter, self._tol, self._atol = maxiter, tol, atol
        self._preconditioner = preconditioner
        self._last_info: dict | None = None
        self.SELF_ADJOINT = A.SELF_ADJOINT

    @property
    def last_info(self) -> dict | None:
        """Iteration counts, residual norms and host reads of the last solve."""
        return self._last_info

    def set_cg_hyperparameters(self, **kwargs) -> None:
        """Update the solver's ``maxiter``, ``tol`` and ``atol``."""
        _set(self, ("maxiter", "tol", "atol"), kwargs, "CG")

    def _matmat(self, M: Any) -> Any:
        P = self._preconditioner
        loop = _loop(self, M, ("cg", self._maxiter, self._tol, self._atol), (self._A, P),
                     "the CG solve")
        X, info = batched_cg(
            self._A._matmat, M, maxiter=self._maxiter, tol=self._tol, atol=self._atol,
            preconditioner=P._matmat if P is not None else None, loop=loop,
        )
        self._last_info = {**info, "host_reads": loop.host_reads}
        return X

    def _adjoint(self) -> "CGInverseLinearOperator":
        return CGInverseLinearOperator(
            self._A.adjoint(), maxiter=self._maxiter, tol=self._tol, atol=self._atol,
            preconditioner=self._preconditioner,
        )


class MINRESInverseLinearOperator(LinearOperator):
    """``A^{-1}`` for a symmetric, possibly indefinite ``A`` by batched MINRES.

    Symmetry is taken from ``A.SELF_ADJOINT`` (the curvature operators set
    it; set it on a symmetric :class:`~curvlinops_tpu_torch.ops.dense.
    MatrixLinearOperator` yourself).
    """

    SELF_ADJOINT = True

    def __init__(
        self,
        A: LinearOperator,
        *,
        maxiter: int = 100,
        tol: float = 1e-5,
        atol: float = 1e-8,
    ):
        _require_square(A)
        if not A.SELF_ADJOINT:
            raise ValueError("MINRES requires a symmetric operator.")
        super().__init__(A.in_spec, A.out_spec)
        self._A = A
        self._maxiter, self._tol, self._atol = maxiter, tol, atol
        self._last_info: dict | None = None

    @property
    def last_info(self) -> dict | None:
        """Iteration counts, residual-norm estimates and host reads of the last solve."""
        return self._last_info

    def set_minres_hyperparameters(self, **kwargs) -> None:
        """Update the solver's ``maxiter``, ``tol`` and ``atol``."""
        _set(self, ("maxiter", "tol", "atol"), kwargs, "MINRES")

    def _matmat(self, M: Any) -> Any:
        loop = _loop(self, M, ("minres", self._maxiter, self._tol, self._atol), (self._A,),
                     "the MINRES solve")
        X, info = batched_minres(
            self._A._matmat, M, maxiter=self._maxiter, tol=self._tol, atol=self._atol, loop=loop
        )
        self._last_info = {**info, "host_reads": loop.host_reads}
        return X


class LSMRInverseLinearOperator(LinearOperator):
    """Least-squares (pseudo-)inverse by batched LSMR: maps the output space
    of ``A`` back to its input space.

    Its adjoint is the LSMR inverse of ``A^T`` with the same damping, since
    ``A (A^T A + d^2 I)^{-1} = (A A^T + d^2 I)^{-1} A``.
    """

    def __init__(
        self,
        A: LinearOperator,
        *,
        damp: float = 0.0,
        maxiter: int = 100,
        atol: float = 1e-6,
        btol: float = 1e-6,
    ):
        super().__init__(A.out_spec, A.in_spec)
        self._A, self._A_adj = A, A.adjoint()
        self._damp, self._maxiter, self._atol, self._btol = damp, maxiter, atol, btol
        self._lsmr_info: dict | None = None

    @property
    def lsmr_info(self) -> dict | None:
        """Iteration count, ``normr`` / ``normar`` and host reads of the last solve."""
        return self._lsmr_info

    def set_lsmr_hyperparameters(self, **kwargs) -> None:
        """Update the solver's ``damp``, ``maxiter``, ``atol`` and ``btol``."""
        _set(self, ("damp", "maxiter", "atol", "btol"), kwargs, "LSMR")

    def _matmat(self, M: Any) -> Any:
        loop = _loop(self, M, ("lsmr", self._damp, self._maxiter, self._atol, self._btol),
                     (self._A, self._A_adj), "the LSMR solve")
        X, info = batched_lsmr(
            self._A._matmat, self._A_adj._matmat, M, damp=self._damp,
            maxiter=self._maxiter, atol=self._atol, btol=self._btol, loop=loop,
        )
        self._lsmr_info = {**info, "host_reads": loop.host_reads}
        return X

    def _adjoint(self) -> "LSMRInverseLinearOperator":
        return LSMRInverseLinearOperator(
            self._A_adj, damp=self._damp, maxiter=self._maxiter, atol=self._atol,
            btol=self._btol,
        )


class NeumannInverseLinearOperator(LinearOperator):
    r"""Truncated, rescaled Neumann-series inverse.

    ``A^{-1} ~= scale * sum_{k<=K} (I - scale * A)^k``, with an optional
    left preconditioner ``P`` (Wang et al., NeurIPS 2025):
    ``A^{-1} ~= scale * sum_{k<=K} (I - scale P A)^k P``.

    A diverging series produces NaNs: a device-side flag records the first
    term with one, and the apply raises ``ValueError`` after the loop (the
    loop itself reads nothing to the host). Where ``A`` and ``P`` are
    ``capturable``, the series runs as one cached captured program per number
    of columns and dtype, with ``scale`` and ``num_terms`` built in
    (:meth:`set_neumann_hyperparameters` drops it); over any other operator
    (a streamed or mesh curvature operator, a solver) it runs eagerly.
    """

    def __init__(
        self,
        A: LinearOperator,
        *,
        num_terms: int = 100,
        scale: float = 1.0,
        check_nan: bool = True,
        preconditioner: LinearOperator | None = None,
    ):
        _require_square(A)
        super().__init__(A.in_spec, A.out_spec)
        self._A = A
        self._num_terms, self._scale = num_terms, scale
        self._check_nan = check_nan
        self._preconditioner = preconditioner
        self.SELF_ADJOINT = A.SELF_ADJOINT and preconditioner is None

    def set_neumann_hyperparameters(
        self, num_terms: int | None = None, scale: float | None = None
    ) -> None:
        """Update the truncation length and the rescaling (drops the cached
        programs)."""
        if num_terms is not None:
            self._num_terms = num_terms
        if scale is not None:
            self._scale = scale
        self.invalidate_traced()

    def _series(self) -> Callable:
        """The series as a function ``M -> (scale * sum_k term_k, flag,
        first_bad)``, holding the operators and hyperparameters, not
        ``self``."""
        A_mm, scale = self._A._matmat, self._scale
        P_mm = self._preconditioner._matmat if self._preconditioner is not None else None
        num_terms, check_nan = self._num_terms, self._check_nan

        def series(M: Any) -> tuple[Any, torch.Tensor, torch.Tensor]:
            m, ravel, unravel = flatten_columns(M)
            A = on_flat(A_mm, ravel, unravel)
            apply_P = on_flat(P_mm, ravel, unravel) if P_mm is not None else (lambda V: V)
            term = result = apply_P(m)  # the k = 0 term, P M
            flag = torch.zeros((), dtype=torch.bool, device=m.device)
            first_bad = torch.full((), -1, dtype=torch.int64, device=m.device)
            for k in range(1, num_terms + 1):
                term = term - scale * apply_P(A(term))
                if check_nan:
                    isnan = torch.isnan(term).any()
                    first_bad = first_bad.masked_fill(~flag & isnan, k)
                    flag = flag | isnan
                result = result + term
            return unravel(scale * result), flag, first_bad

        return series

    def _matmat(self, M: Any) -> Any:
        P = self._preconditioner
        if self._A.capturable and (P is None or P.capturable):
            leaf = pytree.tree_leaves(M)[0]
            series = cached_program(
                self, ("neumann", leaf.shape[-1], leaf.dtype),
                lambda: CapturedProgram(
                    self._series(), self.device, "the Neumann series",
                    program_pool(self, self.device), SOLVER_REMEDY,
                ),
            )
        else:  # A or P streams, holds a mesh or is not marked capturable
            series = self._series()
        result, flag, first_bad = series(M)
        if self._check_nan and bool(flag):  # the one host read, after the series
            raise ValueError(
                f"Neumann series diverged (NaN at term {int(first_bad)}); "
                "decrease `scale` or the spectral radius of I - scale*A."
            )
        return result

    def _adjoint(self) -> LinearOperator:
        P = self._preconditioner
        return NeumannInverseLinearOperator(
            self._A.adjoint(), num_terms=self._num_terms, scale=self._scale,
            check_nan=self._check_nan,
            preconditioner=P.adjoint() if P is not None else None,
        )
