"""The port's operator core and structured operators against the JAX package.

``ops/base.py`` (``todense(col_chunk=)``, ``to_scipy``, chain
``__setitem__``, algebra, formats and refusals), ``ops/dense.py``,
``ops/diagonal.py``, ``ops/submatrix.py``, ``ops/stacked.py`` (and
``kfac/chain.py::stacked_kron_inverse``), the embedding blocks of
``ops/kronecker.py`` and ``utils/misc.py``, each from the same numpy
inputs as its counterpart in ``curvlinops_tpu``, on the CPU. Tolerances:
1e-6 relative in float32 where both sides sum in the same order, float64
at 1e-10 where sums reorder (the batched contractions, the inverses).

The port guards the Martens-Grosse ``pi = sqrt(mean2 / mean1)`` against a
zero factor trace in the embedding block's and the stacked blocks'
heuristic inverses; the JAX package's ``ops/kronecker.py:329`` and
``kfac/chain.py:220`` divide by it. Those two tests assert the difference.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import scipy.sparse.linalg
import torch
from torch import nn

import curvlinops_tpu as J
from curvlinops_tpu.ops import kronecker as jkron
from curvlinops_tpu.ops import stacked as jstacked
from curvlinops_tpu.utils import misc as jmisc
from curvlinops_tpu.utils.flatten import spec_of as jspec_of
import curvlinops_tpu_torch as T
from curvlinops_tpu_torch.kfac.chain import stacked_kron_inverse
from curvlinops_tpu_torch.ops import kronecker as tkron
from curvlinops_tpu_torch.ops import stacked as tstacked
from curvlinops_tpu_torch.utils import misc as tmisc
from curvlinops_tpu_torch.utils.flatten import spec_of
from tests.test_torch_helpers import assert_close, capped_torch_threads

_threads = capped_torch_threads()

F32 = dict(rtol=1e-6, atol=1e-6)  # float32, the same sums in the same order
F64 = dict(rtol=1e-10, atol=1e-12)  # float64, sums in another order


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _spd(rng, n: int, dtype=np.float32, stack: tuple = ()) -> np.ndarray:
    A = rng.standard_normal(stack + (n, n))
    return (A @ np.swapaxes(A, -1, -2) / n + np.eye(n)).astype(dtype)


def _ops(kind: str, rng):
    """The same operator in both packages (JAX, port) and its dense matrix,
    the JAX tests' oracle (``tests/test_ops_base.py``)."""
    if kind == "matrix":
        A = rng.standard_normal((7, 5)).astype(np.float32)
        return (J.MatrixLinearOperator(jnp.asarray(A)), T.MatrixLinearOperator(torch.from_numpy(A)),
                A)
    if kind == "identity":
        tree = {"a": np.zeros((3, 2), np.float32), "b": np.zeros(4, np.float32)}
        return (J.IdentityLinearOperator(jspec_of(jax.tree.map(jnp.asarray, tree))),
                T.IdentityLinearOperator(spec_of({k: torch.from_numpy(v) for k, v in tree.items()})),
                np.eye(10, dtype=np.float32))
    if kind == "outer":
        U = rng.standard_normal((6, 2)).astype(np.float32)
        return (J.OuterProductLinearOperator(jnp.asarray(U), c=0.5),
                T.OuterProductLinearOperator(torch.from_numpy(U), c=0.5), 0.5 * U @ U.T)
    # keys in sorted order: the JAX package flattens a dict by sorted key,
    # the port by insertion order
    d = {"b": np.array([2.0, 3.0], np.float32),
         "w": np.arange(1.0, 7.0, dtype=np.float32).reshape(2, 3)}
    return (J.DiagonalLinearOperator(jax.tree.map(jnp.asarray, d)),
            T.DiagonalLinearOperator({k: torch.from_numpy(v) for k, v in d.items()}),
            np.diag(np.concatenate([v.ravel() for v in d.values()])))


@pytest.mark.parametrize("kind", ["matrix", "identity", "outer", "diagonal"])
def test_dense_operators(kind):
    """The port's ``A @ X``, ``A^T @ Y``, ``Y @ A`` (flat), tree formats,
    ``todense`` with and without column chunks and ``to_scipy`` products
    against the dense matrix, float32; shape, symmetry flag and SciPy dtype
    as the JAX package's."""
    rng = np.random.default_rng(0)
    j, t, dense = _ops(kind, rng)
    assert t.shape == j.shape and t.SELF_ADJOINT == j.SELF_ADJOINT
    X = rng.standard_normal((t.shape[1], 3)).astype(np.float32)
    Y = rng.standard_normal((2, t.shape[0])).astype(np.float32)
    assert_close(t @ torch.from_numpy(X), dense @ X, **F32, name="A @ X")
    assert_close(t.T @ torch.from_numpy(Y.T), dense.T @ Y.T, **F32, name="A^T @ Y")
    assert_close(Y @ t, Y @ dense, **F32, name="Y @ A")
    assert_close(t.todense(), dense, **F32, name="todense")
    assert_close(t.todense(col_chunk=2), dense, **F32, name="todense(col_chunk=2)")
    sp = t.to_scipy()
    assert isinstance(sp, scipy.sparse.linalg.LinearOperator) and sp.dtype == j.to_scipy().dtype
    assert_close(sp @ X[:, 0], dense @ X[:, 0], **F32, name="to_scipy matvec")
    assert_close(sp.rmatvec(Y[0]), dense.T @ Y[0], **F32, name="to_scipy rmatvec")
    assert_close(sp.matmat(X), dense @ X, **F32, name="to_scipy matmat")
    assert_close(sp.rmatmat(Y.T), dense.T @ Y.T, **F32, name="to_scipy rmatmat")
    assert t.to_scipy(np.float64).dtype == np.float64
    if kind in ("identity", "diagonal"):  # tree spaces answer in the caller's format
        tree = {n: torch.randn(s.shape) for n, s in t.in_spec.items()}
        flat = torch.cat([v.reshape(-1) for v in tree.values()]).numpy()
        out = torch.cat([v.reshape(-1) for v in (t @ tree).values()])
        cols = t @ {n: v[..., None] for n, v in tree.items()}
        assert_close(out, dense @ flat, **F32, name="tree")
        assert_close(torch.cat([v.reshape(-1) for v in cols.values()]), dense @ flat, **F32,
                     name="tree with a column axis")


def test_diagonal_algebra_and_properties():
    """Closure under ``+``, ``@`` and scalar ``*``; the damped inverse;
    trace, det, logdet and Frobenius norm (the JAX test's dense oracles)."""
    _, t, dense = _ops("diagonal", np.random.default_rng(0))
    pairs = {"sum": (t + t, 2 * dense), "product": (t @ t, dense @ dense),
             "scaled": (3.0 * t, 3.0 * dense), "by a 0-d tensor": (t * torch.tensor(2.0), 2 * dense),
             "inverse": (t.inverse(damping=0.5), np.linalg.inv(dense + 0.5 * np.eye(8)))}
    for name, (op, expected) in pairs.items():
        assert isinstance(op, T.DiagonalLinearOperator), name
        assert_close(op.todense(), expected, **F32, name=name)
    expected = {"trace": np.trace(dense), "det": np.linalg.det(dense),
                "logdet": np.linalg.slogdet(dense)[1], "frobenius_norm": np.linalg.norm(dense)}
    for prop, value in expected.items():
        assert_close(getattr(t, prop)(), np.float32(value), rtol=1e-6, atol=0, name=prop)


def test_algebra_and_chain():
    """Sum, difference, scalings, negation and adjoints; a nested chain,
    its adjoint, element replacement and the refusals (the JAX test's dense
    oracles; float64, since the chain's products sum in another order)."""
    rng = np.random.default_rng(2)
    mats = [rng.standard_normal(s) for s in ((5, 5), (5, 5), (4, 6), (6, 3), (3, 5), (6, 3))]
    t = [T.MatrixLinearOperator(torch.from_numpy(m)) for m in mats]
    m = mats
    cases = {
        "A + B": (t[0] + t[1], m[0] + m[1]), "A - B": (t[0] - t[1], m[0] - m[1]),
        "2.5 A": (2.5 * t[0], 2.5 * m[0]), "A * 2.5": (t[0] * 2.5, 2.5 * m[0]),
        "A / 2": (t[0] / 2.0, m[0] / 2), "-A": (-t[0], -m[0]),
        "(A + B)^T": ((t[0] + t[1]).adjoint(), (m[0] + m[1]).T),
        "chain": (t[2] @ (t[3] @ t[4]), m[2] @ m[3] @ m[4]),
        "chain^T": ((t[2] @ t[3] @ t[4]).T, (m[2] @ m[3] @ m[4]).T),
    }
    for name, (op, expected) in cases.items():
        assert_close(op.todense(), expected, **F64, name=name)
    chain = t[2] @ t[3] @ t[4]
    assert isinstance(chain, T.ChainLinearOperator) and len(chain) == 3
    chain[1] = t[5]
    assert_close(chain.todense(), m[2] @ m[5] @ m[4], **F64, name="chain[1] = C")
    with pytest.raises(ValueError, match="shape"):
        chain[1] = t[2]
    with pytest.raises(ValueError):
        _ = t[3] @ t[2]  # incompatible chain


def test_chain_setitem_refuses_another_space():
    """A replacement of the same shape over a differently structured space."""
    D = T.DiagonalLinearOperator({"a": torch.ones(2, 2)})
    chain = T.ChainLinearOperator([D, D])
    with pytest.raises(ValueError, match="tree structure"):
        chain[0] = T.MatrixLinearOperator(torch.eye(4))


@pytest.mark.parametrize("case", ["shape", "flat input", "array scalar", "array divisor", "space"])
def test_refusals(case):
    """The JAX package's refusals, case by case: a sum of shapes that differ,
    a flat input of the wrong length, array scalings, and sums or chains over
    structurally different spaces of one flat size."""
    A = T.MatrixLinearOperator(torch.ones(4, 3))
    with pytest.raises(ValueError):
        {
            "shape": lambda: A + T.MatrixLinearOperator(torch.ones(5, 3)),
            "flat input": lambda: A @ np.ones(7),
            "array scalar": lambda: torch.tensor([1.0, 2.0]) * A,
            "array divisor": lambda: A / np.asarray([1.0, 2.0]),
            "space": lambda: T.DiagonalLinearOperator({"a": torch.ones(2, 2)})
            + T.MatrixLinearOperator(torch.eye(4)),
        }[case]()


# ---------------------------------------------------------------------- #
# submatrix
# ---------------------------------------------------------------------- #
def test_submatrix():
    """``A[rows][:, cols]`` (the JAX test's oracle) and the adjoint."""
    rng = np.random.default_rng(9)
    A = rng.standard_normal((7, 5)).astype(np.float32)
    rows, cols = [0, 2, 6], [1, 3, 4]
    t = T.SubmatrixLinearOperator(T.MatrixLinearOperator(torch.from_numpy(A)), rows, cols)
    assert_close(t.todense(), A[np.ix_(rows, cols)], **F32, name="A[rows][:, cols]")
    assert_close(t.T.todense(), A[np.ix_(rows, cols)].T, **F32, name="adjoint")


@pytest.mark.parametrize("rows", [[0, 0], [0, 9], [0.5], [], [[0]]],
                         ids=["duplicates", "out-of-range", "non-integer", "empty", "2d"])
def test_submatrix_validation(rows):
    with pytest.raises(ValueError):
        T.SubmatrixLinearOperator(T.MatrixLinearOperator(torch.eye(4)), rows, [1])


# ---------------------------------------------------------------------- #
# stacked Kronecker / eigh
# ---------------------------------------------------------------------- #
def _props(dense: np.ndarray) -> dict:
    return {"trace": np.trace(dense), "det": np.linalg.det(dense),
            "logdet": np.linalg.slogdet(dense)[1], "frobenius_norm": np.linalg.norm(dense)}


def _assert_props(op, dense: np.ndarray) -> None:
    for prop, value in _props(dense).items():
        assert_close(getattr(op, prop)(), value, **F64, name=prop)


@pytest.mark.parametrize("dims", [(3,), (3, 4), (2, 3, 2)], ids=["k1", "k2", "k3"])
def test_stacked_kronecker(dims):
    """The block diagonal of dense Kronecker products (the JAX test's
    oracle) against the matmat and the adjoint, and the closed-form
    properties against its own (float64: the batched contractions sum in
    another order)."""
    rng = np.random.default_rng(11)
    factors = [_spd(rng, n, np.float64, (3,)) for n in dims]
    blocks = [factors[0][l] for l in range(3)]
    for S in factors[1:]:
        blocks = [np.kron(b, S[l]) for l, b in enumerate(blocks)]
    dense = scipy.linalg.block_diag(*blocks)
    t = tstacked.StackedKroneckerOperator(*map(torch.from_numpy, factors))
    X = rng.standard_normal((t.shape[1], 2))
    assert_close(t @ torch.from_numpy(X), dense @ X, **F64, name="matmat")
    assert_close(t.T @ torch.from_numpy(X), dense.T @ X, **F64, name="adjoint")
    _assert_props(t, dense)


@pytest.mark.parametrize("mode", ["plain", "heuristic", "exact"])
def test_stacked_inverse_matches_jax(mode):
    """The three damping modes against the JAX inverse's matrix, and
    ``StackedEighOperator``'s properties and inverse on the exact mode's
    result, float64."""
    rng = np.random.default_rng(3)
    factors = [_spd(rng, n, np.float64, (2,)) for n in (3, 4)]
    kw = dict(damping=0.1, use_heuristic_damping=mode == "heuristic",
              use_exact_damping=mode == "exact")
    with jax.enable_x64(True):
        j = jstacked.StackedKroneckerOperator(*map(jnp.asarray, factors)).inverse(**kw)
        dense = np.asarray(j.todense())
    t = tstacked.StackedKroneckerOperator(*map(torch.from_numpy, factors)).inverse(**kw)
    assert_close(t.todense(), dense, **F64, name=mode)
    if mode == "exact":
        assert isinstance(t, tstacked.StackedEighOperator) and t.SELF_ADJOINT
        _assert_props(t, dense)
        assert_close(t.inverse(0.3).todense(), np.linalg.inv(dense + 0.3 * np.eye(len(dense))),
                     **F64, name="eigh inverse")


def test_stacked_heuristic_inverse_guards_a_zero_trace():
    """A stack slice whose gradient factor is all zero: the port's ``pi``
    falls back to 1 and both factors take ``sqrt(damping)``; the JAX
    package's ``pi`` is 0 there, which damps the other factor by infinity
    and zeroes the block's inverse."""
    rng = np.random.default_rng(4)
    A, G = _spd(rng, 3, np.float64, (2,)), _spd(rng, 2, np.float64, (2,))
    G[1] = 0.0
    port = stacked_kron_inverse([torch.from_numpy(A), torch.from_numpy(G)], 1e-2, True, 1e-8, True)
    assert_close(port[0][1], np.linalg.inv(A[1] + 0.1 * np.eye(3)), **F64, name="slice 1, A")
    assert_close(port[1][1], np.eye(2) / 0.1, **F64, name="slice 1, G")
    with jax.enable_x64(True):
        from curvlinops_tpu.kfac.chain import stacked_kron_inverse as j_stacked_kron_inverse

        ref = j_stacked_kron_inverse([jnp.asarray(A), jnp.asarray(G)], 1e-2, True, 1e-8, True)
        ref = [[np.asarray(S) for S in f] for f in ref]
    assert_close(port[0][0], ref[0][0], **F64, name="slice 0, A")
    assert_close(port[1][0], ref[1][0], **F64, name="slice 0, G")
    assert not ref[0][1].any()  # the JAX package: a zero inverse for slice 1


# ---------------------------------------------------------------------- #
# embedding blocks
# ---------------------------------------------------------------------- #
def _embedding(rng, dtype=np.float64):
    return _spd(rng, 3, dtype), rng.uniform(0.5, 2.0, size=5).astype(dtype)


def test_embedding_kronecker_matches_jax():
    """``G (x) diag(d)`` against the JAX operator's matrix: matmat, adjoint
    (a non-square ``G`` too) and the closed-form properties, float64."""
    rng = np.random.default_rng(5)
    G, d = _embedding(rng)
    for Gm in (G, rng.standard_normal((2, 3))):
        with jax.enable_x64(True):
            dense = np.asarray(jkron.EmbeddingKroneckerOperator(jnp.asarray(Gm), jnp.asarray(d)).todense())
        t = tkron.EmbeddingKroneckerOperator(torch.from_numpy(Gm), torch.from_numpy(d))
        assert_close(t.todense(), dense, **F64, name="matmat")
        assert_close(t.T.todense(), dense.T, **F64, name="adjoint")
        assert_close(t.todense(), np.kron(Gm, np.diag(d)), **F64, name="against kron")
    _assert_props(tkron.EmbeddingKroneckerOperator(torch.from_numpy(G), torch.from_numpy(d)),
                  np.kron(G, np.diag(d)))


@pytest.mark.parametrize("mode", ["plain", "heuristic", "exact"])
def test_embedding_inverse_matches_jax(mode):
    """The three damping modes against the JAX inverse's matrix; on the
    exact mode's ``EmbeddingEighOperator`` also its properties and inverse,
    float64."""
    rng = np.random.default_rng(6)
    G, d = _embedding(rng)
    kw = dict(damping=0.1, use_heuristic_damping=mode == "heuristic",
              use_exact_damping=mode == "exact")
    with jax.enable_x64(True):
        dense = np.asarray(
            jkron.EmbeddingKroneckerOperator(jnp.asarray(G), jnp.asarray(d)).inverse(**kw).todense()
        )
    t = tkron.EmbeddingKroneckerOperator(torch.from_numpy(G), torch.from_numpy(d)).inverse(**kw)
    assert_close(t.todense(), dense, **F64, name=mode)
    if mode == "exact":
        assert isinstance(t, tkron.EmbeddingEighOperator) and t.SELF_ADJOINT
        _assert_props(t, dense)
        assert_close(t.inverse(0.3).todense(), np.linalg.inv(dense + 0.3 * np.eye(len(dense))),
                     **F64, name="eigh inverse")


def test_embedding_heuristic_inverse_guards_a_zero_trace():
    """All-zero token counts (``d = 0``): the port's heuristic inverse takes
    ``pi = 1`` and is finite; the JAX package's divides by the zero trace
    (``ops/kronecker.py:329``): ``pi = 0`` there, and the next division
    raises ``ZeroDivisionError``."""
    rng = np.random.default_rng(7)
    G, _ = _embedding(rng)
    d = np.zeros(5)
    t = tkron.EmbeddingKroneckerOperator(torch.from_numpy(G), torch.from_numpy(d)).inverse(
        damping=1e-2, use_heuristic_damping=True
    )
    dense = t.todense().numpy()
    assert np.isfinite(dense).all()
    expected = np.kron(np.linalg.inv(G + 0.1 * np.eye(3)), np.eye(5) / 0.1)
    assert_close(dense, expected, **F64, name="pi = 1")
    with jax.enable_x64(True), pytest.raises(ZeroDivisionError):
        jkron.EmbeddingKroneckerOperator(jnp.asarray(G), jnp.asarray(d)).inverse(
            damping=1e-2, use_heuristic_damping=True
        )


# ---------------------------------------------------------------------- #
# utils/misc.py
# ---------------------------------------------------------------------- #
def test_misc_utilities_match_jax(capsys):
    """``split_list`` and ``allclose_report`` (its answer and its report)
    as the JAX package's; ``make_functional_call`` applies an ``nn.Module``
    on a partial parameter dict and passes a callable through."""
    xs = list(range(7))
    assert tmisc.split_list(xs, [2, 0, 5]) == jmisc.split_list(xs, [2, 0, 5])
    with pytest.raises(ValueError):
        tmisc.split_list(xs, [2, 2])
    a = np.arange(6.0).reshape(2, 3)
    b = a.copy()
    b[1, 2] += 1.0
    assert tmisc.allclose_report(torch.from_numpy(a), a) is True
    capsys.readouterr()
    assert tmisc.allclose_report(torch.from_numpy(a), b) is jmisc.allclose_report(a, b) is False
    port_report, jax_report = capsys.readouterr().out.split("  ... 1/6 entries differ\n")[:2]
    assert port_report == jax_report and "(1, 2)" in port_report

    model = nn.Linear(3, 2)
    fn = tmisc.make_functional_call(model)
    X = torch.randn(4, 3, generator=torch.Generator().manual_seed(0))
    W = torch.zeros(2, 3)
    assert_close(fn({"weight": W}, X), model.bias.detach().expand(4, 2), **F32, name="partial")
    assert tmisc.make_functional_call(torch.sin) is torch.sin
    with pytest.raises(ValueError):
        tmisc.make_functional_call(3)
