"""The design of the small-eigh kernel's cluster route, on the CPU.

The kernel (``curvlinops_tpu_torch/solvers/csrc/small_eigh.cu``) runs only
on the card, where ``tests/test_torch_cuda.py`` holds it to its plain
version. This file checks its algorithm with a float64 PyTorch model written
here, with the kernel's schedule and arithmetic: ``n`` padded with zero rows
and columns to ``N = 32 m``, ``2m`` blocks of 16 indices paired round-robin
in ``2m - 1`` super-rounds a sweep, each pair's ``[32, 32]`` sub-matrix
rotated in 31 round-robin rounds in a sweep's first super-round and in 16
rounds of the pairs across its two blocks in the others (the kernel's one
CTA a pair; an annihilated entry set to zero, not computed), each diagonal
tile the rotated sub-matrix and the rest of A and V^T updated by the pairs'
accumulated rotations (the kernel's tensor-core products), and the sweeps
stopped where the off-diagonal squares fall to ``eps^2`` times the squared
norm. It checks
that the schedules pair what a sweep needs, once and disjointly, that the
padding never mixes with the matrix, and that the model converges within
``MAX_SWEEPS`` to ``torch.linalg.eigh``.
"""

from __future__ import annotations

import itertools

import numpy as np
import pytest
import torch

from curvlinops_tpu_torch.solvers import small_eigh as se
from tests.test_torch_helpers import capped_torch_threads

_threads = capped_torch_threads()

B = se.BLOCK  # an index block
P = 2 * B  # a pair of blocks: one CTA's sub-matrix


def rr_pair(r: int, k: int, N: int) -> tuple[int, int]:
    """Pair ``k`` of round ``r`` of the round-robin over ``N`` (even) items:
    item ``N - 1`` fixed, the others rotating (the kernel's ``rr_pair``)."""
    a, b = (N - 1, r) if k == 0 else ((r + k) % (N - 1), (r - k) % (N - 1))
    return min(a, b), max(a, b)


def inner_pairs(r: int, full: bool, Ni: int) -> list[tuple[int, int]]:
    """The pairs of a CTA's inner round ``r``: round-robin over its ``Ni``
    indices (a sweep's first super-round), or block x's index k against
    block y's ``(k + r) mod 16`` (the others)."""
    if full:
        return [rr_pair(r, k, Ni) for k in range(Ni // 2)]
    return [(k, B + (k + r) % B) for k in range(B)]


def tile_partners(rank: int, m: int) -> list[int]:
    """The off-diagonal tiles ``(rank, j)`` CTA ``rank`` updates (the
    kernel's ``ntiles`` and ``j = (rank + 1 + job) % m``)."""
    ntiles = (m - 1) // 2 + (1 if m % 2 == 0 and rank < m // 2 else 0)
    return [(rank + 1 + job) % m for job in range(ntiles)]


def rotation(app, aqq, apq):
    """The kernel's Jacobi rotation ``(c, s)``, elementwise: two reciprocal
    square roots, no division; the identity where ``a_pq`` is 0."""
    d = aqq - app
    a2 = 4 * apq * apq
    u = d.abs() + torch.sqrt(d * d + a2)
    g = torch.rsqrt(u * u + a2)
    zero = apq == 0
    c = torch.where(zero, 1.0, u * g)
    s = torch.where(zero, 0.0, torch.where(d >= 0, 2 * apq, -2 * apq) * g)
    return c, s


def blocked_jacobi(A: torch.Tensor, max_sweeps: int = se.MAX_SWEEPS):
    """The cluster route's algorithm on a float64 ``[n, n]`` (its lower
    triangle): ``(eigenvalues descending, eigenvectors, sweeps, padded A,
    padded V)``."""
    n = A.shape[-1]
    m, N = se.cluster_shape(n)
    eps = torch.finfo(torch.float64).eps
    L = torch.tril(A)
    Ap = torch.zeros((N, N), dtype=torch.float64)
    Ap[:n, :n] = L + torch.tril(L, -1).T
    V = torch.eye(N, dtype=torch.float64)
    norm2 = float((Ap * Ap).sum())
    Ni = n + n % 2 if m == 1 else P
    sweeps = 0
    off = lambda M: float((M - torch.diag(M.diagonal())).square().sum())  # noqa: E731
    while sweeps < max_sweeps and off(Ap) > eps**2 * norm2:
        for R in range(2 * m - 1):
            # phase A: every pair's sub-matrix at once, [m, 32, 32]
            idx = torch.stack([torch.cat([torch.arange(bx * B, bx * B + B),
                                          torch.arange(by * B, by * B + B)])
                               for bx, by in (rr_pair(R, k, 2 * m) for k in range(m))])
            S = Ap[idx[:, :, None], idx[:, None, :]]
            Q = torch.eye(P, dtype=torch.float64).repeat(m, 1, 1)
            full = R == 0
            for r in range(Ni - 1 if full else B):
                p, q = (torch.tensor(t) for t in zip(*inner_pairs(r, full, Ni)))
                c, s = rotation(S[:, p, p], S[:, q, q], S[:, p, q])
                J = torch.eye(P, dtype=torch.float64).repeat(m, 1, 1)
                J[:, p, p], J[:, q, q], J[:, p, q], J[:, q, p] = c, c, s, -s
                S = J.transpose(1, 2) @ S @ J
                S[:, p, q] = S[:, q, p] = 0.0  # annihilated: set, not computed
                Q = Q @ J
            # phase B: A <- Q^T A Q and V <- V Q, Q block-diagonal on the
            # pairs; each diagonal tile is phase A's S (not a product)
            Qf = torch.zeros((N, N), dtype=torch.float64)
            for k in range(m):
                Qf[idx[k][:, None], idx[k][None, :]] = Q[k]
            Ap = Qf.T @ Ap @ Qf
            for k in range(m):
                Ap[idx[k][:, None], idx[k][None, :]] = S[k]
            V = V @ Qf
        sweeps += 1
    w = Ap.diagonal()[:n]
    order = torch.argsort(w, descending=True, stable=True)
    return w[order], V[:n, :n][:, order], sweeps, Ap, V


@pytest.mark.parametrize("m", [1, 2, 3, 4, 5, 8, 10, 16])
def test_block_round_robin_pairs_every_block_pair_once(m):
    """A sweep's ``2m - 1`` super-rounds pair the ``2m`` blocks disjointly
    within each super-round, and every pair of blocks exactly once; each
    pair's off-diagonal tiles go to exactly one CTA."""
    seen = []
    for R in range(2 * m - 1):
        pairs = [rr_pair(R, k, 2 * m) for k in range(m)]
        blocks = [b for pair in pairs for b in pair]
        assert sorted(blocks) == list(range(2 * m))
        seen += pairs
    assert sorted(seen) == list(itertools.combinations(range(2 * m), 2))
    tiles = [frozenset((k, j)) for k in range(m) for j in tile_partners(k, m)]
    assert len(tiles) == len(set(tiles)) == m * (m - 1) // 2


@pytest.mark.parametrize("Ni", [2, 12, 32])
def test_inner_rounds_pair_every_index_pair_once(Ni):
    """A CTA's first super-round rotates every pair of its ``Ni`` indices
    once in ``Ni - 1`` rounds, the later ones every pair across its two
    blocks once in 16 rounds; each round's pairs are disjoint. With the
    super-rounds' block pairs, a sweep rotates every index pair of ``N``."""
    for full, rounds, want in ((True, Ni - 1, itertools.combinations(range(Ni), 2)),
                               (False, B, itertools.product(range(B), range(B, P)))):
        if not full and Ni != P:
            continue
        seen = []
        for r in range(rounds):
            pairs = inner_pairs(r, full, Ni)
            flat = [i for pair in pairs for i in pair]
            assert len(set(flat)) == len(flat)
            seen += pairs
        assert sorted(seen) == sorted(want)


@pytest.mark.parametrize("n", [12, 45, 120, 121])
def test_blocked_model_converges_to_eigh(n):
    """The model on a random symmetric float64 matrix: converged within
    ``MAX_SWEEPS`` (the sweeps close to the scalar order's, at most 11),
    eigenvalues within ``20 n eps ||A||`` of ``torch.linalg.eigh``, its
    eigenvectors orthonormal and ``A V = V diag(w)`` to ``20 n eps``, and
    the padding exactly zero off the matrix's own block in A and V."""
    rng = np.random.default_rng(n)
    X = torch.from_numpy(rng.standard_normal((n, n)))
    A = (X + X.T) / 2
    w, V, sweeps, Ap, Vp = blocked_jacobi(A)
    assert 0 < sweeps <= 11 < se.MAX_SWEEPS
    tol = 20 * n * torch.finfo(torch.float64).eps
    scale = float(A.norm())
    w_ref = torch.linalg.eigvalsh(A).flip(-1)
    assert float((w - w_ref).abs().max()) <= tol * scale
    assert float((A @ V - V * w).norm()) <= tol * scale
    assert float((V.T @ V - torch.eye(n, dtype=torch.float64)).norm()) <= tol
    assert not bool(Ap[:n, n:].any()) and not bool(Ap[n:, :n].any())
    assert not bool(Vp[:n, n:].any()) and not bool(Vp[n:, :n].any())
