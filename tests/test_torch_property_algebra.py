"""Property-based operator algebra, against the JAX package, on the CPU.

Twins of ``tests/test_property_algebra.py`` with its ``hypothesis`` settings:
random expression trees of the lazy algebra (sum, scalar scale, negation,
chain, adjoint) over random base operators (matrix, diagonal, identity,
outer product), each built in the port and in the JAX package from the same
numpy arrays, beside the same expression evaluated on dense matrices. The
port's composite is held to the dense mirror (``todense``, matvec, matmat,
the adjoint's ``todense``, the SciPy export; JAX's rtol and atol 2e-4,
float32) and its matmat to the JAX composite's.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import curvlinops_tpu as cl
import curvlinops_tpu_torch as T
from curvlinops_tpu_torch.utils.flatten import TensorSpec
from tests.test_torch_helpers import capped_torch_threads

_threads = capped_torch_threads()

DIM = 6
TOL = dict(rtol=2e-4, atol=2e-4)  # JAX's, float32


def _base_operator(draw):
    """``(port operator, JAX operator, dense ndarray)`` of one base kind."""
    kind = draw(st.sampled_from(["matrix", "diagonal", "identity", "outer"]))
    rng = np.random.default_rng(draw(st.integers(0, 2**16)))
    if kind == "matrix":
        dense = rng.normal(size=(DIM, DIM)).astype(np.float32)
        return (T.MatrixLinearOperator(torch.from_numpy(dense)),
                cl.MatrixLinearOperator(jnp.asarray(dense)), dense)
    if kind == "diagonal":
        d = rng.normal(size=DIM).astype(np.float32)
        return (T.DiagonalLinearOperator(torch.from_numpy(d)),
                cl.DiagonalLinearOperator(jnp.asarray(d)), np.diag(d))
    if kind == "outer":
        c = float(rng.uniform(0.5, 2.0))
        a = rng.normal(size=DIM).astype(np.float32)
        return (T.OuterProductLinearOperator(torch.from_numpy(a), c),
                cl.OuterProductLinearOperator(jnp.asarray(a), c), c * np.outer(a, a))
    return (T.IdentityLinearOperator(TensorSpec((DIM,), torch.float32, torch.device("cpu"))),
            cl.IdentityLinearOperator(jax.ShapeDtypeStruct((DIM,), jnp.float32)),
            np.eye(DIM, dtype=np.float32))


@st.composite
def expressions(draw, depth=0):
    """``(port operator, JAX operator, dense ndarray)`` of a random algebra
    expression."""
    if depth >= 2 or draw(st.booleans()):
        return _base_operator(draw)
    combinator = draw(st.sampled_from(["sum", "scale", "chain", "neg", "adj"]))
    op_a, j_a, d_a = draw(expressions(depth=depth + 1))
    if combinator == "sum":
        op_b, j_b, d_b = draw(expressions(depth=depth + 1))
        return op_a + op_b, j_a + j_b, d_a + d_b
    if combinator == "chain":
        op_b, j_b, d_b = draw(expressions(depth=depth + 1))
        return op_a @ op_b, j_a @ j_b, d_a @ d_b
    if combinator == "scale":
        c = draw(st.floats(-3.0, 3.0, allow_nan=False).filter(lambda v: abs(v) > 1e-3))
        return c * op_a, c * j_a, np.float32(c) * d_a
    if combinator == "neg":
        return -op_a, -j_a, -d_a
    return op_a.T, j_a.T, d_a.T


@settings(max_examples=60, deadline=None)
@given(expressions(), st.integers(0, 2**16))
def test_expression_matches_dense(expr, vec_seed):
    """``todense``, a matvec, a three-column matmat (against the column-wise
    mirror) and the adjoint's ``todense``; the matmat also against the JAX
    composite's."""
    op, jop, dense = expr
    np.testing.assert_allclose(op.todense().numpy(), dense, **TOL)
    v = np.random.default_rng(vec_seed).normal(size=DIM).astype(np.float32)
    np.testing.assert_allclose(np.asarray(op @ v), dense @ v, **TOL)
    M = np.random.default_rng(vec_seed + 1).normal(size=(DIM, 3)).astype(np.float32)
    np.testing.assert_allclose(np.asarray(op @ M), dense @ M, **TOL)
    np.testing.assert_allclose(np.asarray(op @ M), np.asarray(jop @ jnp.asarray(M)), **TOL)
    np.testing.assert_allclose(op.T.todense().numpy(), dense.T, **TOL)


@settings(max_examples=30, deadline=None)
@given(expressions())
def test_scipy_export_matches(expr):
    """The SciPy export's matvec against the dense mirror."""
    op, _, dense = expr
    A = op.to_scipy()
    v = np.random.default_rng(0).normal(size=DIM).astype(np.float32)
    np.testing.assert_allclose(A @ v, dense @ v, **TOL)
