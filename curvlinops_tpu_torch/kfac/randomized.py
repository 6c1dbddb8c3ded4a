"""Randomized low-rank exact-damped KFAC inversion (RS-KFAC style).

PyTorch counterpart of ``curvlinops_tpu/kfac/randomized.py``. Exact damping
needs the full spectrum of every Kronecker factor, because the damped
inverse mixes eigenvalues as ``1 / (lam_i * mu_j + delta)``; a full
``eigh`` per factor is the expensive step. Here each factor larger than the
rank gets a randomized rank-``r`` eigendecomposition instead (randomized
subspace iteration, "Randomized K-FACs", arXiv:2206.15397):

1. range finding: ``Y = S @ Omega`` with a Gaussian ``Omega [D, r]``,
   orthonormalized by Householder QR (``torch.linalg.qr``). A Gram-matrix
   orthonormalization would square the spectrum's dynamic range, and on a
   KFAC spectrum (power-law decay) float32 resolves only the Gram
   eigenvalues within ``~r * eps`` of the top: every rank collapses to an
   effective rank of about 15. QR is orthonormal whatever the rank of
   ``Y``: completion columns beyond ``rank(Y)`` land orthogonal to
   ``range(S)``, get core eigenvalues ``~0`` and are harmless;
2. optional power iterations ``Y <- S @ Q``;
3. a small core eigh ``Q^T S Q = V diag(lam) V^T`` (all cores across the
   model are ``[r, r]`` and solve as one batched eigh);
4. a trace-preserving tail: the discarded ``D - r`` eigenvalues are
   represented by their exact mean ``alpha = (tr(S) - sum(lam)) / (D - r)``
   on the orthogonal complement of ``span(U)``.

The per-factor approximation ``S ~= U diag(lam) U^T + alpha (I - U U^T)``
has a closed-form damped Kronecker inverse in the four sectors
``span(U_A) x span(U_G)``, ``span x perp``, ``perp x span``,
``perp x perp``; every sector is a matmul (:func:`lr_apply`). With
``rank >= D`` the decomposition is the exact ``eigh`` and the inverse
equals the exact-damped one.

The range-finder and core products run with TF32 off
(:func:`~curvlinops_tpu_torch.utils.misc.full_float32_matmul`), whatever
the caller's setting: the JAX package computes them at
``precision=HIGHEST``. Gaussian test matrices are drawn from an explicit
``torch.Generator`` on the generator's device and moved to the factors'
device, so a CPU generator gives the same build on any device; every
function that draws also takes the test matrix itself. Scan-stacked
factors ``[L, D, D]`` batch through every step, and their sector data
carries the leading ``L`` axis (``"slreigh"`` blocks, :func:`lr_apply_stacked`).
"""

from __future__ import annotations

import math

import torch

from curvlinops_tpu_torch.ops.base import LinearOperator
from curvlinops_tpu_torch.parallel.mesh import DataShards
from curvlinops_tpu_torch.utils.flatten import TensorSpec
from curvlinops_tpu_torch.utils.misc import full_float32_matmul


def default_generator(generator: torch.Generator | None) -> torch.Generator:
    """``generator``, or a CPU generator seeded 0: repeated builds are
    deterministic unless the caller passes a fresh generator."""
    return torch.Generator().manual_seed(0) if generator is None else generator


def gaussian(shape: tuple, generator: torch.Generator, like: torch.Tensor) -> torch.Tensor:
    """Standard normal test matrix drawn on ``generator``'s device, returned
    on ``like``'s device and dtype."""
    draw = torch.randn(shape, generator=generator, dtype=like.dtype, device=generator.device)
    return draw.to(like.device)


def orthonormal_range(Y: torch.Tensor) -> torch.Tensor:
    """Orthonormalize the columns of ``Y [..., D, r]`` by Householder QR."""
    return torch.linalg.qr(Y).Q


def randomized_eigh(
    S: torch.Tensor,
    rank: int,
    generator: torch.Generator | None = None,
    power_iters: int = 1,
    omega: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Rank-``r`` randomized eigendecomposition of PSD ``S [..., D, D]``.

    Args:
        S: The PSD matrices.
        rank: The rank ``r``.
        generator: Draws the test matrix when ``omega`` is not given
            (default: a CPU generator seeded 0).
        power_iters: Subspace iterations after the first range finding.
        omega: The Gaussian test matrix ``[..., D, r]`` itself.

    Returns:
        ``(lam [..., r], U [..., D, r], tail [...])`` with
        ``S ~= U diag(lam) U^T + tail (I - U U^T)``; ``rank >= D`` gives the
        exact ``eigh`` and ``tail = 0``.
    """
    D = S.shape[-1]
    if rank >= D:
        lam, U = torch.linalg.eigh(S)
        return lam, U, S.new_zeros(S.shape[:-2])
    if omega is None:
        omega = gaussian((*S.shape[:-2], D, rank), default_generator(generator), S)
    with full_float32_matmul():
        Q = orthonormal_range(S @ omega)
        for _ in range(power_iters):
            Q = orthonormal_range(S @ Q)
        core = Q.mT @ (S @ Q)
        core = (core + core.mT) / 2
        lam, V = torch.linalg.eigh(core)
        # on a rank-deficient S the QR completion pads the basis with
        # directions whose core eigenvalues are roundoff of either sign; a
        # negative one would flip the sign of a damped-inverse denominator,
        # so clamp to the PSD cone (those directions get the tail's treatment)
        lam = lam.clamp(min=0.0)
        U = Q @ V
    tail = (torch.diagonal(S, dim1=-2, dim2=-1).sum(-1) - lam.sum(-1)) / (D - rank)
    return lam, U, tail.clamp(min=0.0)


def _range_core(
    stacked: torch.Tensor, omega: torch.Tensor, power_iters: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Range finding and core of a ``[b, D, D]`` stack: batched matmuls and
    tall-skinny QR. Returns ``(Q [b, D, r], core [b, r, r], trace [b])``."""
    with full_float32_matmul():
        Q = orthonormal_range(stacked @ omega)
        for _ in range(power_iters):
            Q = orthonormal_range(stacked @ Q)
        core = Q.mT @ (stacked @ Q)
    core = (core + core.mT) / 2
    return Q, core, torch.diagonal(stacked, dim1=-2, dim2=-1).sum(-1)


def batched_randomized_eigh(
    mats: dict,
    rank: int,
    generator: torch.Generator | None = None,
    power_iters: int = 1,
    mesh=None,
    data_axis: str = "data",
) -> dict:
    """Randomized eigendecomposition of a dict of PSD ``[..., D, D]`` matrices.

    Equal shapes share one batched range finding (the shapes in sorted
    order, each batch's test matrix ``[b, D, r]`` drawn in turn from
    ``generator``; a stacked ``[L, D, D]`` value counts ``L`` matrices); all
    cores, which are ``[r, r]`` whatever ``D``, solve as one batched
    ``eigh``. Matrices with ``D <= rank`` take the exact ``eigh`` (their
    decomposition is complete either way). Results keep the values' leading
    stack axes.

    With ``mesh``, each shape's range finding is split over the mesh's
    ``data_axis``: the test matrices are drawn for the whole stack on every
    process from the same generator, so the mesh does not change them; the
    stack is padded to a multiple of the axis size with identities whose
    test matrices are zero, each process runs its contiguous chunk, and the
    results are gathered with the pad dropped. The core and full ``eigh``s
    split the same way (:func:`~curvlinops_tpu_torch.kfac.chain.batched_eigh`).

    Returns:
        ``{key: (lam, U, tail)}`` as :func:`randomized_eigh`.
    """
    from curvlinops_tpu_torch.kfac.chain import _mesh_sharded_eigh

    shards = DataShards(mesh, data_axis)

    generator = default_generator(generator)
    by_shape: dict = {}
    for k, m in mats.items():
        by_shape.setdefault(tuple(m.shape), []).append(k)
    out: dict = {}
    cores, metas = [], []
    for shape, keys in sorted(by_shape.items()):
        D = shape[-1]
        stacked = torch.cat([mats[k].reshape(-1, D, D) for k in keys])
        if D <= rank:
            lam, U = _mesh_sharded_eigh(stacked, mesh, data_axis)
            _scatter_back(out, mats, keys, lam, U, stacked.new_zeros(stacked.shape[0]))
            continue
        omega = gaussian((stacked.shape[0], D, rank), generator, stacked)
        pads = (torch.eye(D, dtype=stacked.dtype, device=stacked.device)[None],
                omega.new_zeros((1, D, rank)))
        Q, core, tr = shards.map_stack(
            lambda S, W: _range_core(S, W, power_iters), (stacked, omega), pads
        )
        cores.append(core)
        metas.append((keys, Q, tr, D))
    if not cores:
        return out
    w_all, V_all = _mesh_sharded_eigh(torch.cat(cores), mesh, data_axis)
    w_all = w_all.clamp(min=0.0)  # PSD clamp, as in randomized_eigh
    lead = 0
    for keys, Q, tr, D in metas:
        n = Q.shape[0]
        lam, V = w_all[lead : lead + n], V_all[lead : lead + n]
        lead += n
        with full_float32_matmul():
            U = Q @ V
        tail = ((tr - lam.sum(-1)) / (D - rank)).clamp(min=0.0)
        _scatter_back(out, mats, keys, lam, U, tail)
    return out


def _scatter_back(out: dict, mats: dict, keys: list, lam, U, tail) -> None:
    """Unstack per-key results, restoring each value's leading stack axes."""
    lead = 0
    for k in keys:
        batch = mats[k].shape[:-2]
        n = math.prod(batch)
        sl = slice(lead, lead + n)
        out[k] = (
            lam[sl].reshape(*batch, -1), U[sl].reshape(*batch, *U.shape[1:]),
            tail[sl].reshape(batch),
        )
        lead += n


# ---------------------------------------------------------------------- #
# damped Kronecker inverse of two low-rank + tail factors: 4-sector apply
# ---------------------------------------------------------------------- #
def lr_damped_inverse_data(eig_A: tuple, eig_G: tuple, damping: float) -> tuple:
    """Sector inverse scales of ``(A (x) G + delta I)^{-1}``.

    With ``A ~= U_A diag(lam) U_A^T + a (I - P_A)`` and ``G`` alike, the
    damped Kronecker product is diagonal in the sectors
    ``{span(U_A), perp} x {span(U_G), perp}`` with eigenvalues
    ``lam_i mu_j``, ``lam_i b``, ``a mu_j`` and ``a b``. Leading stack axes
    broadcast through.

    Returns:
        ``(U_A, U_G, S11, s12, s21, s22)``.
    """
    lam_A, U_A, a = eig_A
    lam_G, U_G, b = eig_G
    S11 = 1.0 / (lam_A[..., :, None] * lam_G[..., None, :] + damping)
    s12 = 1.0 / (lam_A * b[..., None] + damping)
    s21 = 1.0 / (a[..., None] * lam_G + damping)
    s22 = 1.0 / (a * b + damping)
    return (U_A, U_G, S11, s12, s21, s22)


def lr_apply(data: tuple, comp: torch.Tensor) -> torch.Tensor:
    """Apply a 4-sector operator to flat columns ``comp [dA*dG, K]``.

    The complement projections are formed as differences
    (``X - U U^T X``), so no ``[d, d]`` projector is materialized; every
    contraction is a two-operand product.
    """
    U_A, U_G, S11, s12, s21, s22 = data
    dA, dG = U_A.shape[0], U_G.shape[0]
    K = comp.shape[-1]
    X = comp.reshape(dA, dG, K)
    P1 = torch.einsum("dr,dgk->rgk", U_A, X)  # A-side coefficients
    P2 = torch.einsum("gs,dgk->dsk", U_G, X)  # G-side coefficients
    C = torch.einsum("gs,rgk->rsk", U_G, P1)  # both-span coefficients
    R12 = P1 - torch.einsum("gs,rsk->rgk", U_G, C)
    UC = torch.einsum("dr,rsk->dsk", U_A, C)
    R21 = P2 - UC
    R22 = (
        X
        - torch.einsum("dr,rgk->dgk", U_A, P1)
        - torch.einsum("gs,dsk->dgk", U_G, P2)
        + torch.einsum("gs,dsk->dgk", U_G, UC)
    )
    T11 = torch.einsum("gs,rsk->rgk", U_G, C * S11[:, :, None])
    out = (
        torch.einsum("dr,rgk->dgk", U_A, T11 + R12 * s12[:, None, None])
        + torch.einsum("gs,dsk->dgk", U_G, R21 * s21[None, :, None])
        + R22 * s22
    )
    return out.reshape(dA * dG, K)


def lr_apply_stacked(data: tuple, comp: torch.Tensor) -> torch.Tensor:
    """:func:`lr_apply` for ``L`` sector blocks: every slot carries a leading
    ``L`` axis and ``comp`` is ``[L*dA*dG, K]``; each contraction is one
    batched einsum over the stack."""
    U_A, U_G, S11, s12, s21, s22 = data
    L, dA, dG = U_A.shape[0], U_A.shape[1], U_G.shape[1]
    K = comp.shape[-1]
    X = comp.reshape(L, dA, dG, K)
    P1 = torch.einsum("ldr,ldgk->lrgk", U_A, X)
    P2 = torch.einsum("lgs,ldgk->ldsk", U_G, X)
    C = torch.einsum("lgs,lrgk->lrsk", U_G, P1)
    R12 = P1 - torch.einsum("lgs,lrsk->lrgk", U_G, C)
    UC = torch.einsum("ldr,lrsk->ldsk", U_A, C)
    R21 = P2 - UC
    R22 = (
        X
        - torch.einsum("ldr,lrgk->ldgk", U_A, P1)
        - torch.einsum("lgs,ldsk->ldgk", U_G, P2)
        + torch.einsum("lgs,ldsk->ldgk", U_G, UC)
    )
    T11 = torch.einsum("lgs,lrsk->lrgk", U_G, C * S11[..., None])
    out = (
        torch.einsum("ldr,lrgk->ldgk", U_A, T11 + R12 * s12[:, :, None, None])
        + torch.einsum("lgs,ldsk->ldgk", U_G, R21 * s21[:, None, :, None])
        + R22 * s22[:, None, None, None]
    )
    return out.reshape(L * dA * dG, K)


# ---------------------------------------------------------------------- #
# rank-r EKFAC: sector-corrected spectra
# ---------------------------------------------------------------------- #
def lr_sector_stats(
    g: torch.Tensor, U_g: torch.Tensor, a: torch.Tensor, U_a: torch.Tensor
) -> tuple:
    r"""Per-batch sector sums for rank-``r`` EKFAC eigenvalue correction.

    With partial bases ``U_g [D1, r1]``, ``U_a [D2, r2]`` and per-sample
    gradients ``P_vn = sum_s g_vns a_ns^T``:

    - ``lam11 [r1, r2] = sum_vn (U_g^T P_vn U_a)^2``,
    - ``row_g [r1] = sum_vn ||U_g^T P_vn||_F^2``,
    - ``col_a [r2] = sum_vn ||P_vn U_a||_F^2``,
    - ``total = sum_vn ||P_vn||_F^2`` (through sequence Gramians when
      ``S^2 <= D1 D2``, else through ``P`` itself).

    Every contraction is a pairwise product, rotating the ``S`` rows first.
    """
    zg = g @ U_g  # [V, B, S, r1]
    za = a @ U_a  # [B, S, r2]
    zgT = zg.transpose(-1, -2)  # [V, B, r1, S]
    M11 = zgT @ za  # [V, B, r1, r2]
    lam11 = (M11 * M11).sum(dim=(0, 1))
    Rg = zgT @ a  # [V, B, r1, D2]
    row_g = (Rg * Rg).sum(dim=(0, 1, 3))
    Ca = g.transpose(-1, -2) @ za  # [V, B, D1, r2]
    col_a = (Ca * Ca).sum(dim=(0, 1, 2))
    S, D1, D2 = g.shape[2], g.shape[-1], a.shape[-1]
    if S * S <= D1 * D2:
        gg = g @ g.transpose(-1, -2)  # [V, B, S, S]
        aa = a @ a.transpose(-1, -2)  # [B, S, S]
        total = (gg * aa).sum()
    else:
        P = g.transpose(-1, -2) @ a  # [V, B, D1, D2]
        total = (P * P).sum()
    return lam11, row_g, col_a, total


def lr_corrected_data(U_g: torch.Tensor, U_a: torch.Tensor, stats: tuple) -> tuple:
    """Sector operator data from accumulated sector sums.

    Span x span carries the exact corrected eigenvalues; each complement
    sector carries the mean per-direction mass (inclusion-exclusion over
    the four sums, clipped at zero against roundoff cancellation).

    Returns:
        The ``(U_A, U_G, S11, s12, s21, s22)`` tuple of :func:`lr_apply`
        (the gradient-covariance side first, as in the canonical blocks);
        stacked statistics keep their leading axis.
    """
    lam11, row_g, col_a, total = stats
    dA, rA = U_g.shape[-2:]
    dG, rG = U_a.shape[-2:]
    s12 = (row_g - lam11.sum(-1)).clamp(min=0.0) / max(dG - rG, 1)
    s21 = (col_a - lam11.sum(-2)).clamp(min=0.0) / max(dA - rA, 1)
    s22 = (
        total - row_g.sum(-1) - col_a.sum(-1) + lam11.sum((-2, -1))
    ).clamp(min=0.0) / max((dA - rA) * (dG - rG), 1)
    return (U_g, U_a, lam11, s12, s21, s22)


def lr_map_scales(data: tuple, f) -> tuple:
    """Apply ``f`` elementwise to the four sector scales (bases kept);
    ``f = lambda s: 1 / (s + delta)`` gives the damped inverse."""
    U_A, U_G, S11, s12, s21, s22 = data
    return (U_A, U_G, f(S11), f(s12), f(s21), f(s22))


def _lr_spectrum_reductions(data: tuple) -> dict:
    """trace, squared Frobenius norm and logdet of a sector operator.

    The sector eigenvalues are ``S11`` (multiplicity 1), ``s12_i``
    (``dG - rG`` each), ``s21_j`` (``dA - rA`` each) and ``s22``
    (``(dA - rA)(dG - rG)``); logdet is NaN on a non-positive eigenvalue.
    """
    U_A, U_G, S11, s12, s21, s22 = data
    mA, mG = U_A.shape[-2] - U_A.shape[-1], U_G.shape[-2] - U_G.shape[-1]

    def red(f):
        return f(S11).sum() + mG * f(s12).sum() + mA * f(s21).sum() + mA * mG * f(s22).sum()

    def safe_log(x):
        return torch.where(x > 0, torch.log(torch.where(x > 0, x, 1.0)), torch.nan)

    return {"trace": red(lambda x: x), "frob2": red(lambda x: x**2), "logdet": red(safe_log)}


class LowRankSectorOperator(LinearOperator):
    """One 4-sector block, for the rank-``r`` damped inverse (scales =
    inverse spectra) and for rank-``r`` EKFAC (scales = corrected spectra);
    with a leading stack axis on every slot (``U_A [L, dA, r]``), ``L``
    blocks batched over the stack (``"slreigh"``)."""

    SELF_ADJOINT = True

    def __init__(self, data: tuple):
        U_A, U_G = data[0], data[1]
        n = math.prod(U_A.shape[:-1]) * U_G.shape[-2]
        super().__init__(TensorSpec((n,), U_A.dtype, U_A.device))
        self._data = data
        self._apply = lr_apply_stacked if U_A.ndim == 3 else lr_apply

    def _matmat(self, M: torch.Tensor) -> torch.Tensor:
        return self._apply(self._data, M)

    def trace(self) -> torch.Tensor:
        """Exact trace (closed form over the sector spectrum)."""
        return _lr_spectrum_reductions(self._data)["trace"]

    def frobenius_norm(self) -> torch.Tensor:
        """Exact Frobenius norm."""
        return torch.sqrt(_lr_spectrum_reductions(self._data)["frob2"])

    def logdet(self) -> torch.Tensor:
        """Exact log-determinant; NaN on a non-positive sector eigenvalue."""
        return _lr_spectrum_reductions(self._data)["logdet"]

    def det(self) -> torch.Tensor:
        """Exact determinant, ``exp(logdet)``."""
        return torch.exp(self.logdet())
