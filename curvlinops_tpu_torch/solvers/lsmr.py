"""Batched LSMR (Fong & Saunders 2011) for least-squares inverses, on the device.

PyTorch counterpart of ``curvlinops_tpu/solvers/lsmr.py``: the Golub-Kahan
recurrences are elementwise in the per-column scalars, so all K right-hand
sides run at once; implemented from the published algorithm
(arXiv:1006.0758). As :mod:`.cg`: a step function on flat ``[N, K]``
tensors with all state on the device, driven eagerly or as a captured
chunk of masked iterations; past the stop a masked step changes no state
tensor. Stopping follows the Fong-Saunders rules on ``normr`` and
``normar``.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from curvlinops_tpu_torch.solvers.cg import col_norm, flatten_columns, on_flat, safe
from curvlinops_tpu_torch.utils.graphs import ChunkedLoop, EagerLoop, record


def _converged(X, normr, normar, normA2, normb, atol: float, btol: float):
    """The Fong & Saunders / scipy stopping rules, per column:

    - S1: ``normr  <= btol*normb + atol*normA*normx`` (residual);
    - S2: ``normar <= atol*normA*normr`` (normal equations).

    ``normx`` is the current solution norm: with ``normr`` in its place any
    operator with ``normA >= 1/atol`` "converged" at iteration 0."""
    eps = torch.finfo(normr.dtype).eps
    normA = torch.sqrt(normA2)
    test1 = normr <= btol * normb + atol * normA * col_norm(X)
    test2 = normar <= atol * normA * torch.clamp(normr, min=eps)
    return test1 | test2


def lsmr_step(mv: Callable, rmv: Callable, damp: float, atol: float, btol: float) -> Callable:
    """The LSMR iteration on flat state ``(X, u, v, alpha, h, hbar,
    alphabar, zetabar, zeta, rho, rhobar, cbar, sbar, betadd, betad,
    rhodold, tautildeold, thetatilde, d, normA2, normr, normar, normr
    history, normar history)`` with the constant ``(normb,)``, as a loop
    step."""

    def step(k, state: tuple, consts: tuple) -> tuple:
        (X, u, v, alpha, h, hbar, alphabar, zetabar, zeta, rho, rhobar, cbar, sbar, betadd,
         betad, rhodold, tautildeold, thetatilde, d, normA2, normr, normar, hist_r,
         hist_ar) = state
        (normb,) = consts
        active = ~_converged(X, normr, normar, normA2, normb, atol, btol)

        # Golub-Kahan bidiagonalization step
        u = mv(v) - alpha * u
        beta = col_norm(u)
        u = u / safe(beta, beta == 0)
        v_new = rmv(u) - beta * v
        alpha = col_norm(v_new)
        v = v_new / safe(alpha, alpha == 0)

        # rotation eliminating the damping term
        alphahat = torch.sqrt(alphabar**2 + damp**2)
        chat, shat = alphabar / alphahat, damp / alphahat

        # plane rotation flattening the lower bidiagonal
        rhoold = rho
        rho = torch.sqrt(alphahat**2 + beta**2)
        c, s = alphahat / rho, beta / rho
        thetanew = s * alpha
        alphabar = c * alpha

        # second rotation for the least-squares subproblem
        rhobarold, zetaold = rhobar, zeta
        thetabar = sbar * rho
        rhotemp = cbar * rho
        rhobar = torch.sqrt(rhotemp**2 + thetanew**2)
        cbar, sbar = rhotemp / rhobar, thetanew / rhobar
        zeta = cbar * zetabar
        zetabar = -sbar * zetabar

        # solution update
        hbar = h - (thetabar * rho / (rhoold * rhobarold)) * hbar
        X = X + torch.where(active, zeta / (rho * rhobar), 0.0) * hbar
        h = v - (thetanew / rho) * h

        # residual-norm recurrences (LSMR paper, section 5)
        betaacute = chat * betadd
        betacheck = -shat * betadd
        betahat = c * betaacute
        betadd = -s * betaacute
        thetatildeold = thetatilde
        rhotildeold = torch.sqrt(rhodold**2 + thetabar**2)
        ctildeold, stildeold = rhodold / rhotildeold, thetabar / rhotildeold
        thetatilde = stildeold * rhobar
        rhodold = ctildeold * rhobar
        betad = -stildeold * betad + ctildeold * betahat
        tautildeold = (zetaold - thetatildeold * tautildeold) / rhotildeold
        taud = (zeta - thetatilde * tautildeold) / rhodold
        d = d + betacheck**2
        normr = torch.sqrt(d + (betad - taud) ** 2 + betadd**2)
        normA2 = normA2 + beta**2 + alpha**2
        normar = zetabar.abs()
        state = (X, u, v, alpha, h, hbar, alphabar, zetabar, zeta, rho, rhobar, cbar, sbar,
                 betadd, betad, rhodold, tautildeold, thetatilde, d, normA2, normr, normar,
                 record(hist_r, k, normr), record(hist_ar, k, normar))
        return state, ~_converged(X, normr, normar, normA2, normb, atol, btol).all()

    return step


def batched_lsmr(
    matvec: Callable[[Any], Any],
    rmatvec: Callable[[Any], Any],
    B: Any,
    *,
    damp: float = 0.0,
    maxiter: int = 100,
    atol: float = 1e-6,
    btol: float = 1e-6,
    loop: ChunkedLoop | EagerLoop | None = None,
) -> tuple[Any, dict]:
    """Solve ``min ||A X - B||`` (+ Tikhonov ``damp``) for all columns at once.

    Args:
        matvec: Applies ``A`` to a column tree of the input space.
        rmatvec: Applies ``A^T`` to a column tree of the output space.
        B: Right-hand sides (output-space tree with a trailing column axis).
        damp: Tikhonov damping.
        maxiter: Iteration cap.
        atol / btol: The LSMR tolerances.
        loop: Drives the iterations (an :class:`EagerLoop` when ``None``).

    Returns:
        ``(X, info)`` with the iteration count (``iterations``), the
        per-column ``normr`` (residual) and ``normar`` (normal-equations
        residual) estimates and, beyond the JAX package's, both before the
        first and after each iteration (``normr_history``,
        ``normar_history`` [iterations + 1, K]).
    """
    b, ravel_out, unravel_out = flatten_columns(B)

    beta = col_norm(b)
    u = b / safe(beta, beta == 0)
    v_raw, ravel_in, unravel_in = flatten_columns(rmatvec(unravel_out(u)))
    mv = on_flat(matvec, ravel_out, unravel_in)
    rmv = on_flat(rmatvec, ravel_in, unravel_out)
    alpha = col_norm(v_raw)
    v = v_raw / safe(alpha, alpha == 0)

    X = torch.zeros_like(v)
    ones, zeros = torch.ones_like(beta), torch.zeros_like(beta)
    normr, normar, normA2 = beta, alpha * beta, alpha**2
    hist_r, hist_ar = (beta.new_zeros((maxiter + 1, b.shape[-1])) for _ in range(2))
    hist_r[0], hist_ar[0] = normr, normar
    # (h, hbar), alphabar, zetabar, zeta, rho, rhobar, cbar, sbar; the
    # residual-norm recurrences' betadd, betad, rhodold, tautildeold,
    # thetatilde, d
    state = (X, u, v, alpha, v, torch.zeros_like(v), alpha, alpha * beta, zeros, ones, ones,
             ones, zeros, beta, zeros, ones, zeros, zeros, zeros, normA2, normr, normar,
             hist_r, hist_ar)
    consts = (beta,)  # normb
    running = ~_converged(X, normr, normar, normA2, beta, atol, btol).all()
    loop = EagerLoop() if loop is None else loop
    state, k, _ = loop(lsmr_step(mv, rmv, damp, atol, btol), maxiter, state, consts, running)
    X, normr, normar, hist_r, hist_ar = state[0], state[20], state[21], state[22], state[23]
    return unravel_in(X), {
        "iterations": k, "normr": normr, "normar": normar,
        "normr_history": hist_r[: k + 1], "normar_history": hist_ar[: k + 1],
    }
