"""The conv input-covariance kernel's plain version against the JAX package.

The Hopper kernel itself runs only on a CUDA device; here its plain PyTorch
version (the path a CPU tensor takes) is held against the Pallas kernel in
interpret mode and against ``kfac/math.py::input_covariance``, and the
kernel gate against the Pallas gate. All comparisons are float32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from curvlinops_tpu.curvature.loss_hessian import KFACType as JKFACType
from curvlinops_tpu.kfac import math as jmath
from curvlinops_tpu.kfac.pallas_kernels import (
    conv_input_covariance as pallas_conv_input_covariance,
    pallas_conv_cov_supported,
)
from curvlinops_tpu_torch.kfac import kernels
from curvlinops_tpu_torch.models.resnet import same_pads

# (kernel, stride, input size): 3x3/s1 pads (1, 1); 3x3/s2 pads (0, 1), the
# asymmetric "SAME" case; 1x1/s2 pads (0, 0)
GEOMETRIES = {"3x3s1": (3, 1, 8), "3x3s2": (3, 2, 8), "1x1s2": (1, 2, 8)}


def _metas(C, kernel, stride, size, pads=None, dilation=1, O=8):
    """Matching JAX (NHWC/HWIO) and port (NCHW/OIHW) conv metadata."""
    if pads is None:
        pads = (same_pads(size, kernel, stride),) * 2
    w_shape = (kernel, kernel, C, O)
    jmeta = {
        "window_strides": (stride, stride),
        "padding": pads,
        "lhs_dilation": (1, 1),
        "rhs_dilation": (dilation, dilation),
        "dimension_numbers": jax.lax.conv_dimension_numbers(
            (1, size, size, C), w_shape, ("NHWC", "HWIO", "NHWC")
        ),
        "feature_group_count": 1,
        "batch_group_count": 1,
        "w_shape": w_shape,
    }
    tmeta = {
        "stride": (stride, stride),
        "padding": pads,
        "kernel": (kernel, kernel),
        "dilation": (dilation, dilation),
        "groups": 1,
        "C": C,
        "w_shape": (O, C, kernel, kernel),
    }
    return jmeta, tmeta


def _covariances(geometry, bias_pad):
    """Plain-version covariance, S and the matching JAX input and metadata."""
    kernel, stride, size = GEOMETRIES[geometry]
    C, B = 16, 2
    x_nhwc = np.random.default_rng(0).standard_normal((B, size, size, C)).astype(np.float32)
    jmeta, tmeta = _metas(C, kernel, stride, size)
    x_t = torch.from_numpy(x_nhwc).permute(0, 3, 1, 2).contiguous()
    cov, S = kernels.conv_input_covariance_plain(x_t, tmeta, bias_pad)
    d = kernel * kernel * C + (bias_pad is not None)
    assert cov.shape == (d, d) and cov.dtype == torch.float32
    assert S == (size // stride) ** 2
    return cov, S, jnp.asarray(x_nhwc), jmeta


# entrywise rtol 1e-5, atol 1e-4: entries are sums of 128 products of O(1)
# values, accumulated in float32 in different orders
RTOL, ATOL = 1e-5, 1e-4
BIAS_PADS = {"nobias": None, "pad1": 1.0, "pad0": 0.0}


@pytest.mark.parametrize("bias", list(BIAS_PADS))
@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_plain_conv_covariance_matches_xla(geometry, bias):
    """Plain version == the JAX package's XLA patches path."""
    cov, S, x, jmeta = _covariances(geometry, BIAS_PADS[bias])
    xla_cov, xla_S = jmath.input_covariance(
        x, "conv", jmeta, JKFACType.EXPAND, bias_pad=BIAS_PADS[bias]
    )
    assert S == xla_S
    np.testing.assert_allclose(cov.numpy(), np.asarray(xla_cov), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize(
    "geometry,bias",
    [("3x3s1", "nobias"), ("3x3s2", "nobias"), ("1x1s2", "nobias"),
     ("3x3s2", "pad1"), ("3x3s2", "pad0")],
)
def test_plain_conv_covariance_matches_pallas(geometry, bias):
    """Plain version == the Pallas kernel in interpret mode: every geometry,
    and both bias pads on the asymmetric-padding case (each interpret-mode
    kernel costs seconds of compilation)."""
    cov, S, x, jmeta = _covariances(geometry, BIAS_PADS[bias])
    pallas_cov, pallas_S = pallas_conv_input_covariance(
        x, jmeta, BIAS_PADS[bias], interpret=True
    )
    assert S == pallas_S
    np.testing.assert_allclose(cov.numpy(), np.asarray(pallas_cov), rtol=RTOL, atol=ATOL)


# (C, kernel, stride, size, pads, dilation)
GATE_TABLE = [
    (16, 3, 1, 8, None, 1),  # smallest eligible backbone conv
    (24, 3, 2, 8, None, 1),
    (64, 3, 1, 8, None, 1),  # ResNet-18 layer1, d = 576
    (16, 1, 2, 8, None, 1),  # 1x1/s2 downsample
    (8, 3, 1, 8, None, 1),  # C < 16
    (20, 3, 1, 8, None, 1),  # C % 8 != 0
    (16, 5, 1, 8, None, 1),  # kh * kw > 9
    (3, 7, 2, 32, None, 1),  # RGB 7x7 stem
    (16, 3, 1, 8, None, 2),  # dilation
    (16, 3, 1, 8, ((-1, 0), (0, 0)), 1),  # cropping
]


@pytest.mark.parametrize("row", GATE_TABLE, ids=lambda r: f"C{r[0]}k{r[1]}s{r[2]}d{r[5]}")
def test_gate_agrees_with_pallas_gate(row):
    C, kernel, stride, size, pads, dilation = row
    jmeta, tmeta = _metas(C, kernel, stride, size, pads, dilation)
    for bias_pad in (None, 1.0):
        expected = pallas_conv_cov_supported((2, size, size, C), jmeta, bias_pad)
        assert kernels.conv_cov_kernel_supported((2, C, size, size), tmeta) == expected


def test_gate_drops_the_vmem_bound():
    """The one deliberate difference: the kernel keeps its accumulator in
    device memory, so d > 1200 (ResNet-18's 3x3 convs at C >= 256) passes."""
    jmeta, tmeta = _metas(256, 3, 1, 4)
    assert not pallas_conv_cov_supported((2, 4, 4, 256), jmeta, None)
    assert kernels.conv_cov_kernel_supported((2, 256, 4, 4), tmeta)


def test_cpu_tensor_takes_plain_path_without_launch():
    _, tmeta = _metas(16, 3, 2, 8)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((2, 16, 8, 8)).astype(np.float32))
    before = kernels.conv_input_covariance.launches
    cov, S = kernels.conv_input_covariance(x, tmeta, 1.0)
    plain, plain_S = kernels.conv_input_covariance_plain(x, tmeta, 1.0)
    assert torch.equal(cov, plain) and S == plain_S
    assert kernels.conv_input_covariance.launches == before == 0
