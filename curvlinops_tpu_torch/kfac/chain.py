"""Application and damped inversion of KFAC chains ``P @ blockdiag @ P^T``.

PyTorch counterpart of ``curvlinops_tpu/kfac/chain.py`` for Kronecker
blocks, eigendecomposed blocks and rank-``r`` sector blocks, each plain,
scan-stacked (a leading ``L`` axis on every factor) or of an embedding
(a diagonal right factor). :class:`KroneckerChainOperator` keeps the
introspectable chain (canonical converters and one operator per block) and
applies it directly block by block; :func:`grouped_kron_inverse` damps and
inverts every factor with one batched Cholesky per distinct factor size
(stacked factors join their size's batch) and reads its two failure flags
back to the host once. :func:`stacked_kron_inverse` damps and inverts the
stacked blocks of ``ops/stacked.py`` alone.
"""

from __future__ import annotations

import math
from typing import Any, Callable

import torch

from curvlinops_tpu_torch.kfac.randomized import (
    LowRankSectorOperator,
    lr_apply,
    lr_apply_stacked,
)
from curvlinops_tpu_torch.ops.base import ChainLinearOperator, PytreeLinearOperator
from curvlinops_tpu_torch.parallel.mesh import DataShards
from curvlinops_tpu_torch.ops.blockdiag import BlockDiagonalLinearOperator
from curvlinops_tpu_torch.ops.eigh import EighDecomposedLinearOperator
from curvlinops_tpu_torch.ops.kronecker import (
    EmbeddingEighOperator,
    EmbeddingKroneckerOperator,
    KroneckerProductLinearOperator,
    cholesky_failed,
    damped_cholesky_inverse,
    kron_matmat,
)
from curvlinops_tpu_torch.ops.stacked import (
    StackedEighOperator,
    StackedKroneckerOperator,
    stacked_kron_matmat,
)
from curvlinops_tpu_torch.utils.flatten import spec_of, zeros_like_spec


def _mesh_sharded_eigh(stacked: torch.Tensor, mesh, data_axis: str) -> tuple:
    """``eigh`` of a ``[n, D, D]`` stack split over a mesh axis (one
    ``eigh`` on this process with ``mesh=None``): the stack
    is padded with identities to a multiple of the axis size, each process
    decomposes its contiguous chunk, and the chunks are gathered to every
    process with the pad dropped."""
    D = stacked.shape[-1]
    eye = torch.eye(D, dtype=stacked.dtype, device=stacked.device)[None]
    return DataShards(mesh, data_axis).map_stack(torch.linalg.eigh, (stacked,), (eye,))


def batched_eigh(mats: dict, mesh=None, data_axis: str = "data") -> dict:
    """Eigendecompose a dict of symmetric matrices, one batched call per shape
    (stacked ``[L, D, D]`` values decompose batched over the stack).

    With ``mesh``, each shape's stack is split over the mesh's
    ``data_axis`` (:func:`_mesh_sharded_eigh`): the independent
    decompositions run on every process, and the results are replicated
    (without a mesh, one ``eigh`` per shape on this process).

    Returns:
        ``{key: (eigenvalues, eigenvectors)}``.
    """
    by_shape: dict = {}
    for k, m in mats.items():
        by_shape.setdefault((tuple(m.shape), m.dtype), []).append(k)
    out = {}
    for (shape, _), keys in by_shape.items():
        stacked = torch.stack([mats[k] for k in keys])
        D = shape[-1]
        w, v = _mesh_sharded_eigh(stacked.reshape(-1, D, D), mesh, data_axis)
        w, v = w.reshape(*stacked.shape[:-1]), v.reshape(stacked.shape)
        for i, k in enumerate(keys):
            out[k] = (w[i], v[i])
    return out


def grouped_kron_inverse(
    blocks: dict,
    damping: float,
    use_heuristic_damping: bool,
    min_damping: float,
) -> dict | None:
    """Plain or heuristic damped inversion of all ``kron``/``skron`` blocks together.

    Equal factor sizes share one batched Cholesky, a stacked ``[L, D, D]``
    factor counting ``L`` matrices; the heuristic Martens-Grosse split is
    computed on the device (per stack slice), with ``pi = 1`` where a
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
            m1, m2 = (S.diagonal(dim1=-2, dim2=-1).mean(-1) for S in fs)
            neg = neg | (m1 < 0).any() | (m2 < 0).any()
            ok = (m1 > 0) & (m2 > 0)
            pi = torch.where(ok, torch.sqrt(m2 / torch.where(ok, m1, 1.0)), 1.0)
            damps[(gi, 0)] = torch.clamp(sqrt_damping / pi, min=min_damping)
            damps[(gi, 1)] = torch.clamp(sqrt_damping * pi, min=min_damping)
        else:
            d = max(damping, min_damping) if use_heuristic_damping else damping
            for fi, S in enumerate(fs):
                damps[(gi, fi)] = torch.full(S.shape[:-2], d, dtype=S.dtype, device=device)
    factors = {(gi, fi): S for gi, (_, fs) in blocks.items() for fi, S in enumerate(fs)}
    by_shape: dict = {}
    for key in sorted(factors):
        S = factors[key]
        by_shape.setdefault((S.shape[-1], S.dtype), []).append(key)
    inv: dict = {}
    failed = torch.zeros((), dtype=torch.bool, device=device)
    for (D, dtype), keys in by_shape.items():
        A = torch.cat([factors[k].reshape(-1, D, D) for k in keys])
        dvec = torch.cat([damps[k].reshape(-1) for k in keys]).to(dtype)
        eye = torch.eye(D, dtype=dtype, device=device)
        L, info = torch.linalg.cholesky_ex(A + dvec[:, None, None] * eye)
        failed = failed | cholesky_failed(L, info)
        inverses = torch.cholesky_inverse(L)
        lead = 0
        for k in keys:
            n = damps[k].numel()
            inv[k] = inverses[lead : lead + n].reshape(factors[k].shape)
            lead += n
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


def _apply_eigh(data: tuple, comp: torch.Tensor) -> torch.Tensor:
    lam, Qs = data
    W = kron_matmat([Q.T for Q in Qs], comp)
    return kron_matmat(Qs, lam.reshape(-1, 1) * W)


def _apply_seigh(data: tuple, comp: torch.Tensor) -> torch.Tensor:
    lam, Qs = data
    W = stacked_kron_matmat([Q.mT for Q in Qs], comp)
    return stacked_kron_matmat(Qs, lam.reshape(-1, 1) * W)


def _apply_krond(data: tuple, comp: torch.Tensor) -> torch.Tensor:
    G, d = data
    X = comp.reshape(G.shape[1], d.shape[0], -1)
    return (torch.einsum("ab,bvk->avk", G, X) * d[None, :, None]).reshape(-1, comp.shape[-1])


def _apply_eighd(data: tuple, comp: torch.Tensor) -> torch.Tensor:
    lam, Q = data
    X = comp.reshape(*lam.shape, -1)
    W = torch.einsum("ba,bvk->avk", Q, X) * lam[:, :, None]
    return torch.einsum("ab,bvk->avk", Q, W).reshape(-1, comp.shape[-1])


# per block kind: its operator (from the block's data) and its apply
_BLOCKS = {
    "kron": (lambda data: KroneckerProductLinearOperator(*data), kron_matmat),
    "skron": (lambda data: StackedKroneckerOperator(*data), stacked_kron_matmat),
    "eigh": (
        lambda data: EighDecomposedLinearOperator(
            data[0].reshape(-1), KroneckerProductLinearOperator(*data[1])
        ),
        _apply_eigh,
    ),
    "seigh": (lambda data: StackedEighOperator(*data), _apply_seigh),
    "krond": (lambda data: EmbeddingKroneckerOperator(*data), _apply_krond),
    "eighd": (lambda data: EmbeddingEighOperator(*data), _apply_eighd),
    "lreigh": (LowRankSectorOperator, lr_apply),
    "slreigh": (LowRankSectorOperator, lr_apply_stacked),
}


def _cast(data, dtype):
    """A block's tensors (nested in lists and tuples) in ``dtype``."""
    if isinstance(data, torch.Tensor):
        return data.to(dtype)
    return type(data)(_cast(t, dtype) for t in data)


class KroneckerChainOperator(ChainLinearOperator):
    """``FromCanonical @ blockdiag(blocks) @ ToCanonical``.

    ``blocks_data[gi]`` is ``(kind, data)``:

    - ``("kron", [factors...])``: a Kronecker block;
    - ``("eigh", (eigenvalues, [Q factors...]))``: an eigendecomposed block;
    - ``("lreigh", (U_A, U_G, S11, s12, s21, s22))``: a rank-``r`` 4-sector
      block (:mod:`curvlinops_tpu_torch.kfac.randomized`);
    - ``"skron"``, ``"seigh"``, ``"slreigh"``: their scan-stacked forms,
      every tensor with a leading ``L`` axis (``ops/stacked.py``);
    - ``("krond", [G, d])``: an embedding block ``G (x) diag(d)``, and
      ``("eighd", (eigenvalues [C, V], Q_G))`` its eigendecomposed form
      (``ops/kronecker.py``).

    ``to_canonical`` / ``from_canonical`` map the parameter dict to the
    tuple of flat canonical blocks and back; both accept trailing column
    axes, and being permutations they are each other's adjoints.
    """

    SELF_ADJOINT = True
    # its own _matmat: reshapes and products of the blocks' tensors, the
    # same on every process (the factors are replicated), no host read
    capturable = True

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
            if kind not in _BLOCKS:
                raise ValueError(f"Unknown block kind {kind!r}.")
            blocks.append(_BLOCKS[kind][0](data))
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
            out.append(_BLOCKS[kind][1](_cast(data, dtype), comp))
        return self._from_canonical(tuple(out))
