"""Batched preconditioned conjugate gradients on the device.

PyTorch counterpart of ``curvlinops_tpu/solvers/cg.py``. The JAX package
runs the solve as one ``lax.while_loop`` program; here the iteration is a
step function on a tuple of device tensors, driven by a loop of
:mod:`curvlinops_tpu_torch.utils.graphs`: eagerly (:class:`EagerLoop`, one
host read of the flag "some column still active" before each iteration) or
as a captured chunk of masked iterations replayed with one host read a
chunk (:class:`ChunkedLoop`, which the inverse operators cache over
``capturable`` operators). Every column carries its own ``alpha`` and
``beta``, and all per-column state (the scalars, the residual norms, the
counts, the residual history) stays on the device. Converged columns freeze
(their ``alpha`` is masked to zero) while the rest keep iterating.

The column trees are flattened once into ``[N, K]`` tensors, so an
iteration's vector work is a few kernels whatever the tree's leaf count;
the operator and the preconditioner still see trees.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
from torch.utils import _pytree as pytree

from curvlinops_tpu_torch.utils.flatten import TensorSpec, make_ravel_unravel_cols
from curvlinops_tpu_torch.utils.graphs import ChunkedLoop, EagerLoop, record


def flatten_columns(tree: Any) -> tuple[torch.Tensor, Callable, Callable]:
    """``(flat, ravel, unravel)`` of a tree whose leaves carry a trailing
    column axis: ``flat`` is ``[N, K]`` and ``ravel`` / ``unravel`` map
    between such trees and ``[N, K']`` tensors."""
    spec = pytree.tree_map(
        lambda x: TensorSpec(tuple(x.shape[:-1]), x.dtype, x.device), tree
    )
    ravel, unravel = make_ravel_unravel_cols(spec)
    return ravel(tree), ravel, unravel


def on_flat(fn: Callable[[Any], Any], ravel: Callable, unravel: Callable) -> Callable:
    """``fn`` on trees as a map of ``[N, K]`` tensors."""
    return lambda X: ravel(fn(unravel(X)))


def col_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-column inner products of two ``[N, K]`` tensors -> ``[K]``."""
    return (a * b).sum(0)


def col_norm(a: torch.Tensor) -> torch.Tensor:
    """Per-column Euclidean norms of an ``[N, K]`` tensor -> ``[K]``."""
    return torch.sqrt(col_dot(a, a))


def safe(x: torch.Tensor, bad: torch.Tensor) -> torch.Tensor:
    """``x`` with 1 where ``bad``: a divisor that cannot be zero."""
    return torch.where(bad, torch.ones_like(x), x)


def cg_step(mv: Callable, mp: Callable) -> Callable:
    """The PCG iteration on flat ``[N, K]`` state ``(X, R, P, rz, resid,
    column counts, residual history)`` with the constant ``(threshold,)``,
    as a loop step (:class:`~curvlinops_tpu_torch.utils.graphs.ChunkedLoop`)."""

    def step(k, state: tuple, consts: tuple) -> tuple:
        X, R, P, rz, resid, col_iters, history = state
        (threshold,) = consts
        active = resid > threshold
        AP = mv(P)
        pAp = col_dot(P, AP)
        alpha = torch.where(active, rz / safe(pAp, pAp == 0), 0.0)
        X = X + alpha * P
        R = R - alpha * AP
        Z = mp(R)
        rz_new = col_dot(R, Z)
        beta = torch.where(active, rz_new / safe(rz, rz == 0), 0.0)
        P = Z + beta * P
        resid = col_norm(R)
        state = (X, R, P, rz_new, resid, col_iters + active, record(history, k, resid))
        return state, (resid > threshold).any()

    return step


def batched_cg(
    matvec: Callable[[Any], Any],
    B: Any,
    *,
    x0: Any = None,
    maxiter: int = 100,
    tol: float = 1e-5,
    atol: float = 1e-8,
    preconditioner: Callable[[Any], Any] | None = None,
    loop: ChunkedLoop | EagerLoop | None = None,
) -> tuple[Any, dict]:
    """Solve ``A X = B`` column-wise with PCG.

    Args:
        matvec: Linear map on column trees (applies A to all K columns).
        B: Right-hand sides as a tree with a trailing column axis.
        x0: Initial guess (zeros if ``None``).
        maxiter: Iteration cap.
        tol: Relative residual tolerance (per column, vs ``||b||``).
        atol: Absolute residual tolerance floor.
        preconditioner: Approximate inverse of A on column trees.
        loop: Drives the iterations (an :class:`EagerLoop` when ``None``);
            its ``host_reads`` holds the solve's flag reads afterwards.

    Returns:
        ``(X, info)``: ``info`` has the iteration count (``iterations``:
        until every column converged or the cap), the per-column
        active-iteration counts (``column_iterations`` [K]), the
        per-column final residual norms (``residual_norms`` [K]) and, beyond
        the JAX package's, the recurrence's residual norms before the first
        and after each iteration (``residual_history`` [iterations + 1, K],
        kept on the device).
    """
    b, ravel, unravel = flatten_columns(B)
    mv = on_flat(matvec, ravel, unravel)
    mp = on_flat(preconditioner, ravel, unravel) if preconditioner else (lambda r: r)
    X = ravel(x0) if x0 is not None else torch.zeros_like(b)

    threshold = torch.clamp(tol * col_norm(b), min=atol)
    R = b - mv(X)
    Z = mp(R)
    rz = col_dot(R, Z)
    resid = col_norm(R)
    col_iters = torch.zeros(b.shape[-1], dtype=torch.int32, device=b.device)
    history = resid.new_zeros((maxiter + 1, b.shape[-1]))
    history[0] = resid
    state = (X, R, Z, rz, resid, col_iters, history)
    loop = EagerLoop() if loop is None else loop
    state, k, _ = loop(cg_step(mv, mp), maxiter, state, (threshold,), (resid > threshold).any())
    X, _, _, _, resid, col_iters, history = state
    info = {
        "iterations": k,  # until every column converged, or the cap
        "column_iterations": col_iters,
        "residual_norms": resid,
        "residual_history": history[: k + 1],
    }
    return unravel(X), info
