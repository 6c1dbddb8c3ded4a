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

from curvlinops_tpu.models import resnet as jresnet
from curvlinops_tpu_torch.models import common as tcommon
from curvlinops_tpu_torch.models import resnet as tresnet

NARROW_WIDTHS = (16, 16, 32, 32)
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


def assert_close(actual, expected, rtol: float, atol: float, name: str) -> None:
    """``allclose`` on numpy copies of tensors/arrays, with a diff report."""
    a = actual.detach().cpu().numpy() if isinstance(actual, torch.Tensor) else np.asarray(actual)
    b = expected.detach().cpu().numpy() if isinstance(expected, torch.Tensor) else np.asarray(expected)
    assert a.shape == b.shape, f"{name}: shape {a.shape} vs {b.shape}"
    if not np.allclose(a, b, rtol=rtol, atol=atol):
        err = np.abs(a - b).max()
        raise AssertionError(f"{name}: max abs diff {err} (rtol={rtol}, atol={atol})")


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
    """Torch parameter name of a JAX ``kfac_restricted`` leaf path."""
    key = path[0].key if hasattr(path[0], "key") else path[0]
    parts = tcommon._KEYSTR.findall(key)
    return ".".join(parts[:-1] + [{"W": "weight", "b": "bias"}.get(parts[-1], parts[-1])])


def narrow_resnet(seed: int = 0, batch: int = 2, hw: int = 16, calib: int = 8) -> dict:
    """A narrow ResNet in both packages with the same (calibrated) weights.

    One basic block per stage, widths 16/16/32/32, a 16-channel stem: it
    passes through every stride-2 padding case of ResNet-18 at a test size.
    The JAX side is built from ``models/resnet.py``'s own block initialisers.
    BatchNorm is calibrated on ``calib`` images, of which the first ``batch``
    are the data: calibrating on two 1x1 maps would leave near-zero variances
    whose ``1/sqrt(var + eps)`` amplifies float32 roundoff a few hundred times.
    """
    keys = jax.random.split(jax.random.key(seed), 8)
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
    rng = np.random.default_rng(seed)
    X_calib = rng.uniform(size=(calib, hw, hw, 3)).astype(np.float32)
    X_nhwc = X_calib[:batch]
    y = rng.integers(0, 10, size=batch)
    apply_fn = partial(jresnet.resnet_apply, block="basic")
    uncalibrated = jax.tree.map(np.asarray, params)
    params = jresnet.calibrate_bn(params, jnp.asarray(X_calib), block="basic")

    model = tresnet.ResNet(
        "basic", (1, 1, 1, 1), NARROW_WIDTHS, 10, stem_width=NARROW_WIDTHS[0]
    )
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
