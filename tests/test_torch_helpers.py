"""Shared helpers for the PyTorch port's tests (no tests here).

The port's tests feed the same inputs, made with numpy from a seed, through a
JAX function and its counterpart in ``curvlinops_tpu_torch``, and compare on
the CPU in float32. Weights and parameter-space vectors cross over by name
with ``curvlinops_tpu_torch.models.common.from_jax_params``.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from curvlinops_tpu.models import gpt as jgpt
from curvlinops_tpu.models import resnet as jresnet
from curvlinops_tpu_torch.models import common as tcommon
from curvlinops_tpu_torch.models import resnet as tresnet
from tests.torch_fuzz_cases import (  # noqa: F401  (JAX-free; shared with the card tests)
    assert_close,
    blockdiag_ggn,
    blockdiag_projection,
    dense_of,
)

NARROW_WIDTHS = tresnet.NARROW_WIDTHS
TEST_THREADS = 1  # torch intra-op threads while a port test module runs


def capped_torch_threads():
    """A module-scoped autouse fixture that runs a test module's torch ops on
    :data:`TEST_THREADS` intra-op threads and restores the previous count.

    The suite runs under several pytest workers on one machine; torch's
    default of one thread per core in every worker oversubscribes the cores
    (a 1.6 s float64 ``gradcheck`` took 138 s under six workers). Bind it in
    a test module as ``_threads = capped_torch_threads()``.
    """

    @pytest.fixture(scope="module", autouse=True)
    def _capped():
        before = torch.get_num_threads()
        torch.set_num_threads(TEST_THREADS)
        yield
        torch.set_num_threads(before)

    return _capped


def tf32(x: torch.Tensor) -> torch.Tensor:
    """Round float32 to TF32 (10 mantissa bits), to nearest with ties away
    from zero, on the bits viewed as int32, as the kernels round ``hi``."""
    return ((x.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_truncated(x: torch.Tensor) -> torch.Tensor:
    """float32 as the tensor core reads a TF32 operand: the low 13 bits dropped."""
    return (x.view(torch.int32) & ~0x1FFF).view(torch.float32)


def split_3xtf32(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernels' 3xTF32 split of float32 ``x``: ``hi = tf32(x)`` and
    ``lo = x - hi`` as the tensor core reads it."""
    hi = tf32(x)
    return hi, tf32_truncated(x - hi)


def rel_fro(actual, expected) -> float:
    """Relative Frobenius error ``||a - b|| / ||b||`` in float64."""
    a = np.asarray(actual, np.float64)
    b = np.asarray(expected, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def jax_name(path) -> str:
    """Torch parameter name of a JAX leaf path: ``kfac_restricted``'s
    one-key paths, or a nested dict's key paths."""
    if len(path) > 1:
        *prefix, leaf = (k.key for k in path)
        return ".".join(prefix + [{"W": "weight", "b": "bias"}[leaf]])
    key = path[0].key if hasattr(path[0], "key") else path[0]
    parts = tcommon._KEYSTR.findall(key)
    return ".".join(parts[:-1] + [{"W": "weight", "b": "bias"}.get(parts[-1], parts[-1])])


@jax.jit
def _narrow_resnet_params(key) -> dict:
    """The narrow ResNet's JAX parameters from ``models/resnet.py``'s own
    initialisers, as one compiled program (op by op they take seconds)."""
    keys = jax.random.split(key, 8)
    params = {
        "conv1": {"W": jresnet._init_conv(keys[0], 7, 7, 3, NARROW_WIDTHS[0])},
        "bn1": jresnet._init_bn(NARROW_WIDTHS[0]),
    }
    c_in = NARROW_WIDTHS[0]
    for si, w in enumerate(NARROW_WIDTHS):
        params[f"layer{si + 1}"] = {
            "block0": jresnet._init_basic_block(keys[1 + si], c_in, w, 2 if si else 1)
        }
        c_in = w
    params["fc"] = {
        "W": jresnet.he_normal(keys[5], (c_in, 10), c_in),
        "b": 0.1 * jax.random.normal(keys[6], (10,)),
    }
    return params


_calibrate_bn = jax.jit(partial(jresnet.calibrate_bn, block="basic"))


def narrow_resnet(seed: int = 0, batch: int = 2, hw: int = 16, calib: int = 8) -> dict:
    """A narrow ResNet in both packages with the same (calibrated) weights.

    The port's ``models/resnet.py::narrow_resnet`` geometry: one basic block
    per stage, widths 16/16/32/32, a 16-channel stem. The JAX side is built
    from ``models/resnet.py``'s own block initialisers. BatchNorm is
    calibrated on ``calib`` images, of which the first ``batch`` are the
    data: calibrating on two 1x1 maps would leave near-zero variances whose
    ``1/sqrt(var + eps)`` amplifies float32 roundoff a few hundred times.
    """
    params = _narrow_resnet_params(jax.random.key(seed))
    rng = np.random.default_rng(seed)
    X_calib = rng.uniform(size=(calib, hw, hw, 3)).astype(np.float32)
    X_nhwc = X_calib[:batch]
    y = rng.integers(0, 10, size=batch)
    apply_fn = partial(jresnet.resnet_apply, block="basic")
    uncalibrated = jax.tree.map(np.asarray, params)
    params = _calibrate_bn(params, jnp.asarray(X_calib))

    model = tresnet.narrow_resnet()
    model.load_state_dict(tresnet.from_jax_params(jax.tree.map(np.asarray, params), model))
    return dict(
        jax_params=params,
        jax_uncalibrated=uncalibrated,
        apply_fn=apply_fn,
        X_nhwc=X_nhwc,
        y=y,
        model=model,
        X=torch.from_numpy(X_nhwc).permute(0, 3, 1, 2).contiguous(),
        X_calib=torch.from_numpy(X_calib).permute(0, 3, 1, 2).contiguous(),
        y_t=torch.from_numpy(y),
    )


class SeqMLP(nn.Module):
    """``l0, l1, ...`` dense layers applied at every sequence position
    (weight sharing), tanh between them (unless ``linear``), the output
    flattened to 2d (unless ``flatten`` is off)."""

    def __init__(self, widths, linear: bool = False, flatten: bool = True):
        super().__init__()
        self.n, self.linear, self.flatten = len(widths) - 1, linear, flatten
        for i, (a, b) in enumerate(zip(widths[:-1], widths[1:])):
            setattr(self, f"l{i}", nn.Linear(a, b))

    def forward(self, x):  # noqa: D102
        for i in range(self.n):
            x = getattr(self, f"l{i}")(x)
            if i < self.n - 1 and not self.linear:
                x = torch.tanh(x)
        return x.reshape(x.shape[0], -1) if self.flatten else x


def mlp_pair(widths, batch, seed, seq=None, linear=False):
    """The same MLP (tanh, or ``linear``) in both packages: ``(jax model_fn,
    jax params, jax data, torch model, torch data)`` from numpy draws of
    ``seed`` (weights ``N(0, 0.16)``, biases ``N(0, 0.01)``); ``seq`` adds a
    sequence axis of that length (weight sharing), flattened in the output.
    MSE targets."""
    rng = np.random.default_rng(seed)
    jparams = {
        f"l{i}": {
            "W": (0.4 * rng.standard_normal((a, b))).astype(np.float32),
            "b": (0.1 * rng.standard_normal(b)).astype(np.float32),
        }
        for i, (a, b) in enumerate(zip(widths[:-1], widths[1:]))
    }
    n = len(widths) - 1

    def model_fn(p, x):
        for i in range(n):
            x = x @ p[f"l{i}"]["W"] + p[f"l{i}"]["b"]
            if i < n - 1 and not linear:
                x = jnp.tanh(x)
        return x.reshape(x.shape[0], -1)

    x_shape = (batch, widths[0]) if seq is None else (batch, seq, widths[0])
    X = rng.standard_normal(x_shape).astype(np.float32)
    y = rng.standard_normal((batch, widths[-1] * (seq or 1))).astype(np.float32)
    model = SeqMLP(widths, linear)
    model.load_state_dict(tcommon.from_jax_params(jparams, model))
    return model_fn, jparams, [(X, y)], model, [(torch.from_numpy(X), torch.from_numpy(y))]


def assert_same_vector(actual: dict, expected_jax: dict, model, tol: float, what: str):
    """Each tensor of a port result against the JAX result mapped by name,
    to relative Frobenius error ``tol``."""
    expected = tcommon.from_jax_params(jax.tree.map(np.asarray, expected_jax), model)
    for name in expected:
        err = rel_fro(actual[name].detach().numpy(), expected[name].numpy())
        assert err < tol, f"{what} {name}: relative error {err}"


def random_jax_vector(params, seed: int):
    """A standard normal float32 numpy tree shaped like ``params``."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda p: rng.standard_normal(np.shape(p)).astype(np.float32), params)


def port_order(jparams, model, names) -> torch.Tensor:
    """For each entry of the port's flat parameter vector over ``names``,
    its position in the JAX package's flat order of ``jparams`` (the order
    of a JAX operator's ``todense()``), through ``from_jax_params``' layout
    maps: ``dense_jax[perm][:, perm]`` is in the port's order."""
    leaves, treedef = jax.tree.flatten(jparams)
    index, start = [], 0
    for leaf in leaves:
        size = int(np.prod(np.shape(leaf)))
        index.append(np.arange(start, start + size, dtype=np.float64).reshape(np.shape(leaf)))
        start += size
    mapped = tcommon.from_jax_params(jax.tree.unflatten(treedef, index), model)
    return torch.cat([mapped[n].reshape(-1) for n in names]).round().long()


_jit_init_gpt = jax.jit(jgpt.init_gpt, static_argnums=1)


def jax_gpt_init(config):
    """``curvlinops_tpu.models.gpt.init_gpt(jax.random.key(0), config)`` as
    one compiled program (op by op it takes seconds)."""
    return _jit_init_gpt(jax.random.key(0), config)


def jax_apply(A, v):
    """``A @ v`` of a JAX package operator, traced into one ``jax.jit``
    program (op by op, its first application compiles dozens of small
    programs), as numpy."""
    return jax.tree.map(np.asarray, jax.jit(lambda u: A @ u)(v))
