"""Batched LSMR (Fong & Saunders 2011) for least-squares inverses, on the device.

PyTorch counterpart of ``curvlinops_tpu/solvers/lsmr.py``: the Golub-Kahan
recurrences are elementwise in the per-column scalars, so all K right-hand
sides run at once; implemented from the published algorithm
(arXiv:1006.0758). As :mod:`.cg`: a Python loop over flat ``[N, K]``
tensors with all state on the device and one host read per iteration.
Stopping follows the Fong-Saunders rules on ``normr`` and ``normar``.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from curvlinops_tpu_torch.solvers.cg import col_norm, flatten_columns, on_flat, safe


def batched_lsmr(
    matvec: Callable[[Any], Any],
    rmatvec: Callable[[Any], Any],
    B: Any,
    *,
    damp: float = 0.0,
    maxiter: int = 100,
    atol: float = 1e-6,
    btol: float = 1e-6,
) -> tuple[Any, dict]:
    """Solve ``min ||A X - B||`` (+ Tikhonov ``damp``) for all columns at once.

    Args:
        matvec: Applies ``A`` to a column tree of the input space.
        rmatvec: Applies ``A^T`` to a column tree of the output space.
        B: Right-hand sides (output-space tree with a trailing column axis).
        damp: Tikhonov damping.
        maxiter: Iteration cap.
        atol / btol: The LSMR tolerances.

    Returns:
        ``(X, info)`` with the iteration count (``iterations``), the
        per-column ``normr`` (residual) and ``normar`` (normal-equations
        residual) estimates and, beyond the JAX package's, both before the
        first and after each iteration (``normr_history``,
        ``normar_history`` [iterations + 1, K]).
    """
    b, ravel_out, unravel_out = flatten_columns(B)
    eps = torch.finfo(b.dtype).eps

    beta = col_norm(b)
    u = b / safe(beta, beta == 0)
    v_raw, ravel_in, unravel_in = flatten_columns(rmatvec(unravel_out(u)))
    mv = on_flat(matvec, ravel_out, unravel_in)
    rmv = on_flat(rmatvec, ravel_in, unravel_out)
    alpha = col_norm(v_raw)
    v = v_raw / safe(alpha, alpha == 0)

    X = torch.zeros_like(v)
    h, hbar = v, torch.zeros_like(v)

    zetabar = alpha * beta
    alphabar = alpha
    rho, rhobar, cbar = (torch.ones_like(beta) for _ in range(3))
    sbar = torch.zeros_like(beta)

    # residual-norm recurrence state
    betadd = beta
    betad, tautildeold, thetatilde, zeta, d = (torch.zeros_like(beta) for _ in range(5))
    rhodold = torch.ones_like(beta)

    normA2 = alpha**2
    normb = beta
    normr = beta
    normar = alpha * beta

    def converged() -> torch.Tensor:
        # Fong & Saunders / scipy stopping rules:
        #   S1: normr  <= btol*normb + atol*normA*normx   (residual)
        #   S2: normar <= atol*normA*normr                (normal equations)
        # normx is the current solution norm: with normr in its place any
        # operator with normA >= 1/atol "converged" at iteration 0
        normA = torch.sqrt(normA2)
        test1 = normr <= btol * normb + atol * normA * col_norm(X)
        test2 = normar <= atol * normA * torch.clamp(normr, min=eps)
        return test1 | test2

    history = [(normr, normar)]
    k = 0
    done = converged()
    # the loop's one host read per iteration: has every column converged?
    while k < maxiter and not bool(done.all()):
        active = ~done

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
        history.append((normr, normar))
        k += 1
        done = converged()
    normr_history, normar_history = (torch.stack(h) for h in zip(*history))
    return unravel_in(X), {
        "iterations": k, "normr": normr, "normar": normar,
        "normr_history": normr_history, "normar_history": normar_history,
    }
