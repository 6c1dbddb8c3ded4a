"""The port's Jacobian and transposed Jacobian against the JAX package.

The Jacobian half of ``test_torch_curvature.py``'s cases (its models,
inputs, tolerance and jitted JAX oracles): ``A @ I`` of
``JacobianLinearOperator`` and ``TransposedJacobianLinearOperator``
against the JAX package's Jacobian and its transpose, computed once per
case for both.
"""

from __future__ import annotations

import pytest
import torch

from tests.test_torch_curvature import ATOL, CASES, RTOL, jax_oracle, make_case, port_operator
from tests.test_torch_helpers import assert_close, capped_torch_threads

_threads = capped_torch_threads()


@pytest.fixture(scope="module")
def cache():
    """Cases and JAX Jacobians, built once per module."""
    return {}


def _cached(cache: dict, key, build):
    if key not in cache:
        cache[key] = build()
    return cache[key]


@pytest.mark.parametrize("op", ("jacobian", "jacobian_t"))
@pytest.mark.parametrize("case_name", CASES)
def test_operator_matches_jax(case_name, op, cache):
    """``A @ I`` in the port against the JAX package, float32."""
    case = _cached(cache, case_name, lambda: make_case(case_name))
    J = _cached(cache, (case_name, "J"), lambda: jax_oracle("jacobian", case))
    A = port_operator(op, case)
    actual = A @ torch.eye(A.shape[1])
    assert_close(actual, J if op == "jacobian" else J.T, RTOL, ATOL, f"{case_name} {op}")
