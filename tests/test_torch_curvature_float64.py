"""The port's curvature operators against the JAX package in float64, and
the narrow ResNet in float32 by relative Frobenius error.

The tiny CNN of ``test_torch_curvature.py`` in float64 (``A @ I``), and
the narrow ResNet of ``tests/test_torch_helpers.py`` (one basic block per
stage, widths 16/16/32/32, B=2, calibrated BatchNorm) as an ``nn.Module``
with all its named parameters, against the JAX operators on
``resnet_apply``: ``A @ V`` for two random columns, the port's flat order
mapped to the JAX package's through ``from_jax_params``.

The ResNet runs in float64 (the calibrated float32 weights widened in
both packages, JAX under ``jax.enable_x64``): in float32 the two packages'
GGN matvecs differ by 1.8e-6 in relative Frobenius norm, but the entries
span 0 to 1.8e3, so summation order alone puts errors of 1e-3 on entries
near 0.7, and no elementwise tolerance of the JAX tests' kind holds
there. In float64 both comparisons hold at 1e-10 relative, elementwise,
with no absolute term. In float32, the precision the card runs, the same
two columns are held to 1e-4 in relative Frobenius norm.
"""

from __future__ import annotations

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from curvlinops_tpu import losses as jlosses
from curvlinops_tpu_torch import losses as tlosses
from curvlinops_tpu_torch.models.common import from_jax_params
from tests.test_torch_curvature import JAX, OPERATORS, jax_oracle, make_case, port_operator
from tests.test_torch_helpers import assert_close, capped_torch_threads, narrow_resnet, rel_fro

_threads = capped_torch_threads()

RTOL64 = 1e-10  # float64, elementwise, no absolute term
FRO32 = 1e-4  # float32, relative Frobenius error of the two columns


@pytest.fixture(scope="module")
def resnet():
    """The narrow ResNet at B=2 in both packages, in float64 and in float32
    (keyed by numpy dtype), and the port's flat order as indices into the
    JAX package's."""
    r = narrow_resnet()
    flat, unravel = ravel_pytree(jax.tree.map(np.asarray, r["jax_params"]))
    index_tree = jax.tree.map(np.asarray, unravel(np.arange(flat.size, dtype=np.float64)))
    named = from_jax_params(index_tree, r["model"])
    params = dict(r["model"].named_parameters())
    perm = torch.cat([named[n].reshape(-1) for n in params]).long().numpy()
    out = dict(apply_fn=r["apply_fn"], perm=perm)
    for dtype, model in ((np.float64, copy.deepcopy(r["model"]).double()),
                         (np.float32, r["model"])):
        out[dtype] = dict(
            params_j=jax.tree.map(lambda a: np.asarray(a, dtype), r["jax_params"]),
            data_j=[(r["X_nhwc"].astype(dtype), r["y"])],
            case={"torch": dict(
                model=model, loss_fn=tlosses.CrossEntropyLoss("mean"),
                params=dict(model.named_parameters()),
                data=[(r["X"].to(model.fc.weight.dtype), r["y_t"])], batch_size_fn=None,
            )},
        )
    return out


def _jax_matmat(res: dict, apply_fn, op: str, W: np.ndarray) -> np.ndarray:
    """The JAX operator's product with the columns of ``W`` (JAX's order),
    in the dtype of ``W``."""
    with jax.enable_x64(W.dtype == np.float64):
        params = jax.tree.map(jnp.asarray, res["params_j"])
        data = [(jnp.asarray(X), jnp.asarray(y)) for X, y in res["data_j"]]
        loss = () if op in ("jacobian", "jacobian_t") else (jlosses.CrossEntropyLoss("mean"),)
        A = JAX[op](apply_fn, *loss, params, data, check_deterministic=False)
        out = np.stack([np.asarray(A @ W[:, k]) for k in range(W.shape[1])], axis=1)
    assert out.dtype == W.dtype
    return out


def _resnet_products(resnet: dict, op: str, dtype) -> tuple:
    """``(port, jax)``: ``A @ V`` for two random columns on the narrow
    ResNet in ``dtype``, both in the port's flat order."""
    perm, res = resnet["perm"], resnet[dtype]
    A = port_operator(op, res["case"])
    rng = np.random.default_rng(1)
    if op == "jacobian_t":  # prediction-space columns, the same in both
        W = rng.standard_normal((A.shape[1], 2)).astype(dtype)
        expected = _jax_matmat(res, resnet["apply_fn"], op, W)[perm]
        actual = A @ torch.from_numpy(W)
    else:  # V in the JAX package's flat order is V[perm] in the port's
        V = rng.standard_normal((len(perm), 2)).astype(dtype)
        expected = _jax_matmat(res, resnet["apply_fn"], op, V)
        expected = expected if op == "jacobian" else expected[perm]
        actual = A @ torch.from_numpy(V[perm])
    return actual, expected


@pytest.mark.parametrize("op", OPERATORS)
def test_resnet_operator_matches_jax(resnet, op):
    """``A @ V`` on the narrow ResNet in the port against the JAX package,
    float64, elementwise."""
    actual, expected = _resnet_products(resnet, op, np.float64)
    assert_close(actual, expected, RTOL64, 0.0, f"resnet {op}")


@pytest.mark.parametrize("op", OPERATORS)
def test_resnet_operator_matches_jax_float32(resnet, op):
    """``A @ V`` on the narrow ResNet in the port against the JAX package,
    float32, by relative Frobenius error."""
    actual, expected = _resnet_products(resnet, op, np.float32)
    assert actual.dtype == torch.float32
    err = rel_fro(actual.numpy(), expected)
    assert err < FRO32, f"resnet {op}: relative Frobenius error {err} (tol {FRO32})"


@pytest.mark.parametrize("op", OPERATORS)
def test_operator_matches_jax_float64(op):
    """The tiny CNN in float64: the port against the JAX package under
    ``jax.enable_x64``, to 1e-10 relative."""
    with jax.enable_x64(True):
        case = make_case("cnn_ce", np.float64)
        expected = jax_oracle(op, case)
    assert expected.dtype == np.float64
    A = port_operator(op, case)
    assert A.dtype == torch.float64
    actual = A @ torch.eye(A.shape[1], dtype=torch.float64)
    assert_close(actual, expected, RTOL64, 0.0, f"float64 {op}")
