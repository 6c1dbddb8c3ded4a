"""Application and damped inversion of KFAC chains ``P @ blockdiag @ P^T``.

PyTorch counterpart of ``curvlinops_tpu/kfac/chain.py`` for unstacked
Kronecker blocks, eigendecomposed blocks and rank-``r`` sector blocks.
:class:`KroneckerChainOperator` keeps the introspectable
chain (canonical converters and one operator per block) and applies it
directly block by block; :func:`grouped_kron_inverse` damps and inverts
every factor with one batched Cholesky per distinct factor shape and reads
its two failure flags back to the host once. :func:`stacked_kron_inverse`
damps and inverts the stacked blocks of ``ops/stacked.py``.
"""

from __future__ import annotations

import math
from typing import Any, Callable

import torch

from curvlinops_tpu_torch.kfac.randomized import LowRankSectorOperator, lr_apply
from curvlinops_tpu_torch.ops.base import ChainLinearOperator, PytreeLinearOperator
from curvlinops_tpu_torch.ops.blockdiag import BlockDiagonalLinearOperator
from curvlinops_tpu_torch.ops.eigh import EighDecomposedLinearOperator
from curvlinops_tpu_torch.ops.kronecker import (
    KroneckerProductLinearOperator,
    cholesky_failed,
    damped_cholesky_inverse,
    kron_matmat,
)
from curvlinops_tpu_torch.utils.flatten import spec_of, zeros_like_spec


def batched_eigh(mats: dict) -> dict:
    """Eigendecompose a dict of symmetric matrices, one batched call per shape.

    Returns:
        ``{key: (eigenvalues, eigenvectors)}``.
    """
    by_shape: dict = {}
    for k, m in mats.items():
        by_shape.setdefault((tuple(m.shape), m.dtype), []).append(k)
    out = {}
    for keys in by_shape.values():
        w, v = torch.linalg.eigh(torch.stack([mats[k] for k in keys]))
        for i, k in enumerate(keys):
            out[k] = (w[i], v[i])
    return out


def grouped_kron_inverse(
    blocks: dict,
    damping: float,
    use_heuristic_damping: bool,
    min_damping: float,
) -> dict | None:
    """Plain or heuristic damped inversion of all ``kron`` blocks together.

    Equal factor shapes share one batched Cholesky; the heuristic
    Martens-Grosse split is computed on the device, with ``pi = 1`` where a
    factor's trace is zero. The only host readback is the pair of flags
    "some Cholesky failed" and "a mean eigenvalue is negative".

    Returns:
        ``{gi: [inverted factors...]}``, or ``None`` when some Cholesky
        failed: the caller then inverts block by block with the float64
        retry.

    Raises:
        ValueError: Heuristic damping with more than two factors.
        RuntimeError: Heuristic damping met a negative mean eigenvalue.
    """
    if not blocks:
        return {}
    if use_heuristic_damping and any(len(fs) > 2 for _, fs in blocks.values()):
        raise ValueError("Heuristic damping supports at most two factors.")
    device = next(iter(blocks.values()))[1][0].device
    damps: dict = {}
    neg = torch.zeros((), dtype=torch.bool, device=device)
    sqrt_damping = math.sqrt(damping)
    for gi, (_, fs) in blocks.items():
        if use_heuristic_damping and len(fs) == 2:
            m1, m2 = (torch.diagonal(S).mean() for S in fs)
            neg = neg | (m1 < 0) | (m2 < 0)
            ok = (m1 > 0) & (m2 > 0)
            pi = torch.where(ok, torch.sqrt(m2 / torch.where(ok, m1, 1.0)), 1.0)
            damps[(gi, 0)] = torch.clamp(sqrt_damping / pi, min=min_damping)
            damps[(gi, 1)] = torch.clamp(sqrt_damping * pi, min=min_damping)
        else:
            d = max(damping, min_damping) if use_heuristic_damping else damping
            for fi in range(len(fs)):
                damps[(gi, fi)] = torch.tensor(d, device=device)
    factors = {(gi, fi): S for gi, (_, fs) in blocks.items() for fi, S in enumerate(fs)}
    by_shape: dict = {}
    for key in sorted(factors):
        S = factors[key]
        by_shape.setdefault((S.shape[-1], S.dtype), []).append(key)
    inv: dict = {}
    failed = torch.zeros((), dtype=torch.bool, device=device)
    for (D, dtype), keys in by_shape.items():
        A = torch.stack([factors[k] for k in keys])
        dvec = torch.stack([damps[k] for k in keys]).to(dtype)
        eye = torch.eye(D, dtype=dtype, device=device)
        L, info = torch.linalg.cholesky_ex(A + dvec[:, None, None] * eye)
        failed = failed | cholesky_failed(L, info)
        inverses = torch.cholesky_inverse(L)
        for i, k in enumerate(keys):
            inv[k] = inverses[i]
    flags = torch.stack([failed, neg]).cpu()  # the single host readback
    if flags[1]:
        raise RuntimeError("Negative mean eigenvalue detected.")
    if flags[0]:
        return None
    return {gi: [inv[(gi, fi)] for fi in range(len(fs))] for gi, (_, fs) in blocks.items()}


def stacked_kron_inverse(
    factors: list[torch.Tensor],
    damping: float,
    use_heuristic_damping: bool,
    min_damping: float,
    retry_double_precision: bool,
) -> list[torch.Tensor]:
    """Damped inverse of a stack of Kronecker blocks, batched over the stack.

    Plain and Martens-Grosse heuristic damping as in
    :meth:`~curvlinops_tpu_torch.ops.kronecker.KroneckerProductLinearOperator.inverse`,
    with ``pi`` computed per stack slice, and ``pi = 1`` for a slice whose
    factor has zero trace. (The JAX package's ``kfac/chain.py:220`` divides
    by the zero trace there and returns an infinite ``pi``.)

    Raises:
        ValueError: For heuristic damping with more than two factors.
        RuntimeError: On a negative mean eigenvalue under heuristic damping.
    """
    L, kw = factors[0].shape[0], dict(dtype=factors[0].dtype, device=factors[0].device)
    if use_heuristic_damping and len(factors) > 2:
        raise ValueError(f"Heuristic damping supports at most two factors, got {len(factors)}.")
    if use_heuristic_damping and len(factors) == 2:
        m1, m2 = (S.diagonal(dim1=-2, dim2=-1).mean(-1) for S in factors)
        if bool(((m1 < 0) | (m2 < 0)).any()):
            raise RuntimeError("Negative mean eigenvalue detected.")
        ok = (m1 > 0) & (m2 > 0)
        pi = torch.where(ok, torch.sqrt(m2 / torch.where(ok, m1, 1.0)), 1.0)
        sqrt_damping = math.sqrt(damping)
        dampings = (
            torch.clamp(sqrt_damping / pi, min=min_damping),
            torch.clamp(sqrt_damping * pi, min=min_damping),
        )
    else:
        d = max(damping, min_damping) if use_heuristic_damping else damping
        dampings = tuple(torch.full((L,), d, **kw) for _ in factors)
    return [
        damped_cholesky_inverse(S, d[:, None, None], retry_double_precision)
        for S, d in zip(factors, dampings)
    ]


class KroneckerChainOperator(ChainLinearOperator):
    """``FromCanonical @ blockdiag(blocks) @ ToCanonical``.

    ``blocks_data[gi]`` is ``("kron", [factors...])`` (a Kronecker block),
    ``("eigh", (eigenvalues, [Q factors...]))`` (an eigendecomposed block)
    or ``("lreigh", (U_A, U_G, S11, s12, s21, s22))`` (a rank-``r`` 4-sector
    block, :mod:`curvlinops_tpu_torch.kfac.randomized`).
    ``to_canonical`` / ``from_canonical`` map the parameter dict to the
    tuple of flat canonical blocks and back; both accept trailing column
    axes, and being permutations they are each other's adjoints.
    """

    SELF_ADJOINT = True

    def __init__(
        self,
        params: dict[str, torch.Tensor],
        blocks_data: dict,
        to_canonical: Callable,
        from_canonical: Callable,
    ):
        blocks = []
        for gi in sorted(blocks_data):
            kind, data = blocks_data[gi]
            if kind == "kron":
                blocks.append(KroneckerProductLinearOperator(*data))
            elif kind == "eigh":
                lam, Qs = data
                blocks.append(
                    EighDecomposedLinearOperator(
                        lam.reshape(-1), KroneckerProductLinearOperator(*Qs)
                    )
                )
            elif kind == "lreigh":
                blocks.append(LowRankSectorOperator(data))
            else:
                raise ValueError(f"Unknown block kind {kind!r}.")
        param_spec = spec_of(params)
        canonical_spec = spec_of(to_canonical(zeros_like_spec(param_spec)))
        PT = PytreeLinearOperator(
            to_canonical, param_spec, canonical_spec, adjoint_matvec=from_canonical
        )
        super().__init__([PT.adjoint(), BlockDiagonalLinearOperator(blocks), PT])
        self._blocks_data = blocks_data
        self._to_canonical = to_canonical
        self._from_canonical = from_canonical

    def _matmat(self, M: Any) -> Any:
        cols = self._to_canonical(M)
        dtype = cols[0].dtype  # apply in the operand's dtype
        out = []
        for comp, gi in zip(cols, sorted(self._blocks_data)):
            kind, data = self._blocks_data[gi]
            if kind == "kron":
                out.append(kron_matmat([S.to(dtype) for S in data], comp))
            elif kind == "lreigh":
                out.append(lr_apply(tuple(t.to(dtype) for t in data), comp))
            else:
                lam, Qs = data
                Qs = [Q.to(dtype) for Q in Qs]
                W = kron_matmat([Q.T for Q in Qs], comp)
                out.append(kron_matmat(Qs, lam.reshape(-1, 1).to(dtype) * W))
        return self._from_canonical(tuple(out))
