"""Batched MINRES for symmetric indefinite systems, on the device.

PyTorch counterpart of ``curvlinops_tpu/solvers/minres.py``: MINRES (Paige
& Saunders 1975) minimizes ``||b - A x||`` over the Krylov space of a
symmetric ``A`` with three-term recurrences (the Lanczos + Givens-QR
formulation; Greenbaum 1997, Alg. 2.1 layout), for all K columns at once
with per-column Givens scalars ``[K]``. As :mod:`.cg`: a step function on
flat ``[N, K]`` tensors with all state on the device, driven eagerly or as
a captured chunk of masked iterations. The residual norm is tracked by the
recurrence ``|s_{j+1}| * ||r_j||``.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from curvlinops_tpu_torch.solvers.cg import col_dot, col_norm, flatten_columns, on_flat, safe
from curvlinops_tpu_torch.utils.graphs import ChunkedLoop, EagerLoop, record


def minres_step(mv: Callable, eps: float) -> Callable:
    """The MINRES iteration on flat state ``(X, V, V_prev, W, W_prev, beta,
    c, s, c_old, s_old, eta, res, column counts, residual history)`` with
    the constant ``(threshold,)``, as a loop step."""

    def step(k, state: tuple, consts: tuple) -> tuple:
        X, V, V_prev, W, W_prev, beta, c, s, c_old, s_old, eta, res, col_iters, history = state
        (threshold,) = consts
        active = res > threshold

        # Lanczos step
        P = mv(V)
        alpha = col_dot(V, P)
        P = P - alpha * V - beta * V_prev
        beta_new = torch.sqrt(torch.clamp(col_dot(P, P), min=0.0))
        V_new = P / safe(beta_new, beta_new <= eps)

        # the two previous Givens rotations applied to the new column
        # [beta_j; alpha_j; beta_{j+1}] of the tridiagonal
        delta = c * alpha - c_old * s * beta
        rho2 = s * alpha + c_old * c * beta
        rho3 = s_old * beta
        rho1 = torch.sqrt(delta**2 + beta_new**2)
        safe_r1 = safe(rho1, rho1 <= eps)
        c_new, s_new = delta / safe_r1, beta_new / safe_r1

        # direction update and solution step
        W_new = (V - rho2 * W - rho3 * W_prev) / safe_r1
        X = X + torch.where(active, c_new * eta, 0.0) * W_new

        eta_new = -s_new * eta
        res = torch.where(active, eta_new.abs(), res)
        state = (
            X, V_new, V, W_new, W,
            torch.where(active, beta_new, beta),
            torch.where(active, c_new, c), torch.where(active, s_new, s),
            torch.where(active, c, c_old), torch.where(active, s, s_old),
            torch.where(active, eta_new, eta), res, col_iters + active,
            record(history, k, res),
        )
        return state, (res > threshold).any()

    return step


def batched_minres(
    matvec: Callable[[Any], Any],
    B: Any,
    *,
    x0: Any = None,
    maxiter: int = 100,
    tol: float = 1e-5,
    atol: float = 1e-8,
    loop: ChunkedLoop | EagerLoop | None = None,
) -> tuple[Any, dict]:
    """Solve symmetric (possibly indefinite) ``A X = B`` column-wise.

    Args:
        matvec: Symmetric linear map on column trees.
        B: Right-hand sides as a tree with a trailing column axis.
        x0: Initial guess (zeros if ``None``).
        maxiter: Iteration cap.
        tol: Relative residual tolerance (per column, vs ``||b||``).
        atol: Absolute residual tolerance floor.
        loop: Drives the iterations (an :class:`EagerLoop` when ``None``).

    Returns:
        ``(X, info)``: ``info`` has the iteration count (``iterations``),
        the per-column active-iteration counts (``column_iterations`` [K]),
        the per-column final residual-norm estimates (``residuals``) and,
        beyond the JAX package's, the estimates before the first and after
        each iteration (``residual_history`` [iterations + 1, K]).
    """
    b, ravel, unravel = flatten_columns(B)
    mv = on_flat(matvec, ravel, unravel)
    eps = torch.finfo(b.dtype).eps
    X = ravel(x0) if x0 is not None else torch.zeros_like(b)
    R0 = b - mv(X)

    threshold = torch.clamp(tol * col_norm(b), min=atol)
    beta1 = col_norm(R0)
    V = R0 / safe(beta1, beta1 <= eps)  # v_1
    zeros = torch.zeros_like(b)  # v_0, w_0, w_{-1}
    one, zero = torch.ones_like(beta1), torch.zeros_like(beta1)
    col_iters = torch.zeros(b.shape[-1], dtype=torch.int32, device=b.device)
    history = beta1.new_zeros((maxiter + 1, b.shape[-1]))
    history[0] = beta1
    # beta: the subdiagonal entering step j; (c, s) rotation j-1, (c_old,
    # s_old) rotation j-2; eta the projected right-hand side component; res
    # the residual-norm estimate ||r_{j-1}||
    state = (X, V, zeros, zeros, zeros, beta1, one, zero, one, zero, beta1, beta1,
             col_iters, history)
    loop = EagerLoop() if loop is None else loop
    state, k, _ = loop(minres_step(mv, eps), maxiter, state, (threshold,),
                       (beta1 > threshold).any())
    X, res, col_iters, history = state[0], state[11], state[12], state[13]
    info = {"iterations": k, "column_iterations": col_iters, "residuals": res,
            "residual_history": history[: k + 1]}
    return unravel(X), info
