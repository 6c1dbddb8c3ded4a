"""Plain PyTorch reference of what the benchmark's traffic asks of the
program: a step's gradient, KFAC's empirical-Fisher factors with the
weight-sharing dimension expanded, the Martens-Grosse heuristically damped
inverse applied to a gradient, the damped GGN's product and conjugate
gradients.

A family module (``reference/resnet.py``, ``reference/gpt.py``) supplies the
forward pass and each layer's rows; this module knows nothing else of the
models and nothing of the program.

Conventions (the library's, for a mean-reduced loss over ``R`` loss terms,
here one per datum and output position of the head): a layer with input
rows ``a`` (``n`` data, ``S`` positions each) and output-gradient rows
``g = d loss / d output`` has

- ``A = sum a a^T / (n S)``,
- ``G = R sum g g^T`` (the empirical Fisher: ``g`` is the gradient of the
  mean loss itself, so ``R g`` is the per-term gradient and ``G`` is
  ``sum (R g)(R g)^T / R``),

and a bias's block is ``G`` alone. The heuristic damping splits
``lambda`` as ``G + sqrt(lambda) / pi``, ``A + sqrt(lambda) pi`` with
``pi = sqrt(mean diag A / mean diag G)``; a bias block takes ``G + lambda``.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F


@contextlib.contextmanager
def precision(tf32: bool):
    """Float32 products with TF32 off (the configurations' precision), or
    with TF32 on: the control, one precision below."""
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


def step_outputs(family, cfg: dict, params: dict, X, y) -> tuple[dict, dict]:
    """One step's gradient of the mean cross-entropy with respect to every
    parameter, and the empirical-Fisher factors of every KFAC layer.

    Returns:
        ``(gradient {name: tensor}, factors {weight: (G, A), bias: (G,)})``.
    """
    leaves = {n: p.detach().requires_grad_(True) for n, p in params.items()}
    taps: dict = {}
    logits = family.forward(leaves, X, cfg, taps)
    loss = F.cross_entropy(logits, y)
    names = list(leaves)
    layers = family.kfac_layers(cfg)
    outs = [taps[w][1] for w, _ in layers]
    grads = torch.autograd.grad(loss, [leaves[n] for n in names] + outs)
    gradient = dict(zip(names, grads[: len(names)]))
    R = logits.shape[0]
    factors = {}
    with torch.no_grad():
        for (w, b), out_grad in zip(layers, grads[len(names):]):
            a, g, S = family.layer_rows(w, taps[w][0].detach(), out_grad, cfg)
            n = a.shape[0] // S
            G = R * (g.T @ g)
            factors[w] = (G, (a.T @ a) / (n * S))
            if b is not None:
                factors[b] = (G,)
    return gradient, factors


def gradient(family, cfg: dict, params: dict, X, y) -> dict:
    """The gradient of the mean cross-entropy with respect to every parameter."""
    leaves = {n: p.detach().requires_grad_(True) for n, p in params.items()}
    loss = F.cross_entropy(family.forward(leaves, X, cfg), y)
    return dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))


def heuristic_inverse(factors: dict, damping: float) -> dict:
    """The inverses of every damped factor, keyed as ``factors``."""
    out = {}
    for name, fs in factors.items():
        if len(fs) == 1:
            (G,) = fs
            out[name] = (torch.linalg.inv(G + damping * torch.eye(G.shape[0], dtype=G.dtype,
                                                                  device=G.device)),)
            continue
        G, A = fs
        mG, mA = G.diagonal().mean(), A.diagonal().mean()
        pi = torch.sqrt(mA / mG) if mG > 0 and mA > 0 else torch.ones((), device=G.device)
        root = damping ** 0.5
        eye = lambda M: torch.eye(M.shape[0], dtype=M.dtype, device=M.device)  # noqa: E731
        out[name] = (torch.linalg.inv(G + (root / pi) * eye(G)),
                     torch.linalg.inv(A + (root * pi) * eye(A)))
    return out


def apply_inverse(family, inverses: dict, gradient: dict) -> dict:
    """``G^-1 grad A^-1`` of each weight (``G^-1 grad`` of each bias), in the
    parameters' own shapes."""
    out = {}
    for name, inv in inverses.items():
        g = gradient[name]
        if len(inv) == 1:
            out[name] = inv[0] @ g
            continue
        Gi, Ai = inv
        m = family.canonical(name, g)
        out[name] = family.from_canonical(name, Gi @ m @ Ai, tuple(g.shape))
    return out


def ggn_product(family, cfg: dict, params: dict, X, y, v: dict) -> dict:
    """``J^T H J v`` of the mean cross-entropy: ``J`` the Jacobian of the
    logits with respect to the parameters, ``H = (diag(p) - p p^T) / R`` the
    loss's Hessian in the ``R`` rows of logits."""
    names = list(params)
    primals = tuple(params[n] for n in names)
    tangents = tuple(v[n] for n in names)

    def logits_of(*ps):
        return family.forward(dict(zip(names, ps)), X, cfg)

    logits, jv = torch.func.jvp(logits_of, primals, tangents)
    with torch.no_grad():
        p = torch.softmax(logits, dim=-1)
        hjv = (p * jv - p * (p * jv).sum(-1, keepdim=True)) / logits.shape[0]
    leaves = [t.detach().requires_grad_(True) for t in primals]
    with torch.enable_grad():
        out = logits_of(*leaves)
        grads = torch.autograd.grad(out, leaves, hjv)
    return dict(zip(names, grads))


def cg(matvec, b: dict, iterations: int) -> tuple[dict, torch.Tensor]:
    """``iterations`` steps of conjugate gradients from ``x = 0``, on the
    parameters flattened into one vector.

    Returns:
        ``(x, residual norms)``: the recurrence's residual norms before the
        first step and after each, ``[iterations + 1]``.
    """
    names = list(b)
    shapes = [b[n].shape for n in names]

    def flat(t: dict) -> torch.Tensor:
        return torch.cat([t[n].reshape(-1) for n in names])

    def unflat(f: torch.Tensor) -> dict:
        parts = torch.split(f, [s.numel() for s in shapes])
        return {n: p.reshape(s) for n, p, s in zip(names, parts, shapes)}

    r = flat(b).clone()
    x = torch.zeros_like(r)
    p = r.clone()
    rr = r @ r
    norms = [rr.sqrt()]
    for _ in range(iterations):
        Ap = flat(matvec(unflat(p)))
        alpha = rr / (p @ Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        rr_new = r @ r
        p = r + (rr_new / rr) * p
        rr = rr_new
        norms.append(rr.sqrt())
    return unflat(x), torch.stack(norms)
