"""The port's curvature operators against the JAX package, on the CPU.

GGN (exact), Hessian, empirical Fisher, Jacobian and transposed Jacobian of
``curvlinops_tpu_torch`` against ``curvlinops_tpu`` on small functional
models: the torch counterparts of ``tests/cases.py``'s ``mlp_fn``,
``seq_mlp_fn``, ``dict_mlp_fn`` and ``cnn_fn``, passed as plain callables,
on the JAX parameter layout so that both packages flatten the parameters to
one order. The inputs are made with numpy from a seed. float32 at the JAX
tests' tolerance (rtol 2e-4, atol 5e-6). The float64 cases (the CNN and
the narrow ResNet) are in ``test_torch_curvature_float64.py``, the
Jacobians' float32 cases in ``test_torch_curvature_jacobian.py`` (so that
the suite's workers can take the two halves apart).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from curvlinops_tpu import losses as jlosses
from curvlinops_tpu.curvature.ef import EFLinearOperator as JEF
from curvlinops_tpu.curvature.ggn import GGNLinearOperator as JGGN
from curvlinops_tpu.curvature.hessian import HessianLinearOperator as JHessian
from curvlinops_tpu.curvature.jacobian import JacobianLinearOperator as JJacobian
from curvlinops_tpu.curvature.jacobian import TransposedJacobianLinearOperator as JJacobianT
from curvlinops_tpu_torch import losses as tlosses
from curvlinops_tpu_torch.curvature.ef import EFLinearOperator
from curvlinops_tpu_torch.curvature.ggn import GGNLinearOperator
from curvlinops_tpu_torch.curvature.hessian import HessianLinearOperator
from curvlinops_tpu_torch.curvature.jacobian import (
    JacobianLinearOperator,
    TransposedJacobianLinearOperator,
)
from curvlinops_tpu_torch.models.resnet import same_pads
from tests.cases import cnn_fn, dict_mlp_fn, mlp_fn, seq_mlp_fn
from tests.test_torch_helpers import assert_close, capped_torch_threads

_threads = capped_torch_threads()

RTOL, ATOL = 2e-4, 5e-6  # the JAX package's operator tests (tests/test_ggn.py)

OPERATORS = ("ggn", "hessian", "ef", "jacobian", "jacobian_t")
CASES = (
    "mlp_mse_mean", "mlp_mse_sum", "mlp_ce_mean", "mlp_ce_sum", "mlp_bce_mean",
    "seq_ce_mean", "dict_mse", "cnn_ce",
)
PORT = {
    "ggn": GGNLinearOperator,
    "hessian": HessianLinearOperator,
    "ef": EFLinearOperator,
    "jacobian": JacobianLinearOperator,
    "jacobian_t": TransposedJacobianLinearOperator,
}
JAX = {
    "ggn": JGGN,
    "hessian": JHessian,
    "ef": JEF,
    "jacobian": JJacobian,
    "jacobian_t": JJacobianT,
}


# ---------------------------------------------------------------------- #
# the torch counterparts of tests/cases.py's model functions
# ---------------------------------------------------------------------- #
def t_mlp_fn(params: dict, x: torch.Tensor) -> torch.Tensor:
    """Tanh MLP ``(params, [N, D_in]) -> [N, D_out]`` (``W`` is ``[in, out]``)."""
    n_layers = len(params)
    for i in range(n_layers):
        layer = params[f"layer{i}"]
        x = x @ layer["W"] + layer["b"]
        if i < n_layers - 1:
            x = torch.tanh(x)
    return x


def t_seq_mlp_fn(params: dict, x: torch.Tensor) -> torch.Tensor:
    """Weight-shared MLP over sequences: ``[N, S, D_in] -> [N, C, S]``."""
    return t_mlp_fn(params, x).movedim(-1, 1)


def t_dict_mlp_fn(params: dict, x: dict) -> torch.Tensor:
    """MLP over dict-valued inputs."""
    return t_mlp_fn(params, x["features"])


def t_cnn_fn(params: dict, x: torch.Tensor) -> torch.Tensor:
    """conv(3x3, stride 2, "SAME") -> relu -> flatten -> dense, on NHWC
    ``[N, 8, 8, 1]`` with HWIO weights, as ``tests/cases.py::cnn_fn``."""
    lo, hi = same_pads(x.shape[1], 3, 2)
    z = F.conv2d(
        F.pad(x.permute(0, 3, 1, 2), (lo, hi, lo, hi)),
        params["conv1"]["W"].permute(3, 2, 0, 1), stride=2,
    )
    z = torch.relu(z + params["conv1"]["b"][:, None, None])
    z = z.permute(0, 2, 3, 1).reshape(z.shape[0], -1)
    return z @ params["dense"]["W"] + params["dense"]["b"]


def _mlp_params(rng, sizes, dtype) -> dict:
    # insertion order W, b per layer: the JAX package's sorted-key flat order
    return {
        f"layer{i}": {
            "W": (rng.standard_normal((d_in, d_out)) / np.sqrt(d_in)).astype(dtype),
            "b": (0.1 * rng.standard_normal(d_out)).astype(dtype),
        }
        for i, (d_in, d_out) in enumerate(zip(sizes[:-1], sizes[1:]))
    }


def _split(X, y, n: int) -> list:
    return list(zip(np.split(X, n), np.split(y, n)))


def make_case(name: str, dtype=np.float32) -> dict:
    """One case in both packages: numpy inputs from seed 0, as jnp arrays for
    the JAX package and tensors for the port."""
    rng = np.random.default_rng(0)
    bs_fn = None
    if name.startswith("mlp_"):
        loss, red = name.split("_")[1:]
        sizes = {"mse": [5, 8, 3], "ce": [6, 7, 4], "bce": [4, 6, 2]}[loss]
        params = _mlp_params(rng, sizes, dtype)
        X = rng.standard_normal((12, sizes[0])).astype(dtype)
        y = {
            "mse": lambda: rng.standard_normal((12, sizes[-1])).astype(dtype),
            "ce": lambda: rng.integers(0, sizes[-1], size=12),
            "bce": lambda: rng.integers(0, 2, size=(12, sizes[-1])).astype(dtype),
        }[loss]()
        fns, data = (mlp_fn, t_mlp_fn), _split(X, y, 3)
        losses = {"mse": "MSELoss", "ce": "CrossEntropyLoss", "bce": "BCEWithLogitsLoss"}[loss]
    elif name in ("seq_ce_mean", "seq_ce_ignore"):
        sizes, red, losses = [5, 6, 3], "mean", "CrossEntropyLoss"
        params = _mlp_params(rng, sizes, dtype)
        X = rng.standard_normal((8, 4, sizes[0])).astype(dtype)
        y = rng.integers(0, sizes[-1], size=(8, 4))
        if name == "seq_ce_ignore":  # padded targets: CE's ignore_index (-100)
            y[rng.random(y.shape) < 0.3] = -100
        fns, data = (seq_mlp_fn, t_seq_mlp_fn), _split(X, y, 2)
    elif name == "dict_mse":
        sizes, red, losses = [5, 6, 3], "mean", "MSELoss"
        params = _mlp_params(rng, sizes, dtype)
        X = rng.standard_normal((8, sizes[0])).astype(dtype)
        y = rng.standard_normal((8, sizes[-1])).astype(dtype)
        data = [
            ({"features": xb, "meta": np.zeros(xb.shape[0], dtype)}, yb)
            for xb, yb in _split(X, y, 2)
        ]
        fns = (dict_mlp_fn, t_dict_mlp_fn)
        bs_fn = lambda X: X["features"].shape[0]  # noqa: E731
    elif name == "cnn_ce":
        red, losses = "mean", "CrossEntropyLoss"
        params = {
            "conv1": {"W": 0.3 * rng.standard_normal((3, 3, 1, 4)),
                      "b": 0.05 * rng.standard_normal(4)},
            "dense": {"W": 0.3 * rng.standard_normal((64, 3)),
                      "b": 0.05 * rng.standard_normal(3)},
        }
        params = {k: {n: a.astype(dtype) for n, a in v.items()} for k, v in params.items()}
        X = rng.standard_normal((8, 8, 8, 1)).astype(dtype)
        y = rng.integers(0, 3, size=8)
        fns, data = (cnn_fn, t_cnn_fn), _split(X, y, 2)
    else:
        raise ValueError(name)

    def to_torch(tree):
        if isinstance(tree, dict):
            return {k: to_torch(v) for k, v in tree.items()}
        return torch.from_numpy(np.asarray(tree))

    return dict(
        jax=dict(
            model_fn=fns[0], loss_fn=getattr(jlosses, losses)(red),
            params=jax.tree.map(jnp.asarray, params),
            data=[(jax.tree.map(jnp.asarray, Xb), jnp.asarray(yb)) for Xb, yb in data],
            batch_size_fn=bs_fn,
        ),
        torch=dict(
            model=fns[1], loss_fn=getattr(tlosses, losses)(red), params=to_torch(params),
            data=[(to_torch(Xb), torch.from_numpy(yb)) for Xb, yb in data],
            batch_size_fn=bs_fn,
        ),
    )


def port_operator(op: str, case: dict, **kw):
    """The port's operator ``op`` on a case's torch side."""
    c = case["torch"]
    args = (c["model"], c["params"], c["data"])
    if op not in ("jacobian", "jacobian_t"):
        args = (c["model"], c["loss_fn"], c["params"], c["data"])
    return PORT[op](*args, batch_size_fn=c["batch_size_fn"], **kw)


def jax_oracle(op: str, case: dict) -> np.ndarray:
    """The JAX package's matrix of ``op`` on a case: its operator's ``@ I``
    (its own tests hold each operator against ``curvlinops_tpu.examples``'
    dense oracles), traced into one ``jax.jit`` program: op by op, its
    eager dispatch compiles dozens of small programs and takes seconds."""
    c = case["jax"]
    args = (c["model_fn"], c["params"], c["data"])
    if op not in ("jacobian", "jacobian_t"):
        args = (c["model_fn"], c["loss_fn"], c["params"], c["data"])
    A = JAX[op](*args, batch_size_fn=c["batch_size_fn"], check_deterministic=False)
    return np.asarray(jax.jit(lambda M: A @ M)(jnp.eye(A.shape[1], dtype=A.dtype)))


# ---------------------------------------------------------------------- #
# tests
# ---------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def cache():
    """Cases and JAX oracles, built once per module."""
    return {}


def _cached(cache: dict, key, build):
    if key not in cache:
        cache[key] = build()
    return cache[key]


@pytest.mark.parametrize("op", ("ggn", "hessian", "ef"))
@pytest.mark.parametrize("case_name", CASES)
def test_operator_matches_jax(case_name, op, cache):
    """``A @ I`` in the port against the JAX package, float32 (the Jacobians
    are in ``test_torch_curvature_jacobian.py``)."""
    case = _cached(cache, case_name, lambda: make_case(case_name))
    expected = _cached(cache, (case_name, op), lambda: jax_oracle(op, case))
    A = port_operator(op, case)
    actual = A @ torch.eye(A.shape[1])
    assert_close(actual, expected, RTOL, ATOL, f"{case_name} {op}")
