"""The conv input-covariance kernel's plain version against the JAX package.

The Hopper kernel itself runs only on a CUDA device; here its plain PyTorch
version (the path a CPU tensor takes) is held against the Pallas kernel in
interpret mode and against ``kfac/math.py::input_covariance``, and the
kernel gate against the Pallas gate. An emulation of the kernel's gather,
tiles, row splits and 3xTF32 short sums in plain torch is held against the
plain version. All comparisons are float32.
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
from curvlinops_tpu_torch.kfac.math import extract_conv_patches
from curvlinops_tpu_torch.models.resnet import same_pads
from tests.test_torch_helpers import capped_torch_threads, rel_fro, split_3xtf32

_threads = capped_torch_threads()

# (kernel, stride, input size): 3x3/s1 pads (1, 1); 3x3/s2 pads (0, 1), the
# asymmetric "SAME" case; 1x1/s2 pads (0, 0)
GEOMETRIES = {"3x3s1": (3, 1, 8), "3x3s2": (3, 2, 8), "1x1s2": (1, 2, 8)}


def _metas(C, kernel, stride, size, pads=None, dilation=1, O=8, groups=1):
    """Matching JAX (NHWC/HWIO) and port (NCHW/OIHW) conv metadata."""
    if pads is None:
        pads = (same_pads(size, kernel, stride),) * 2
    w_shape = (kernel, kernel, C // groups, O)
    jmeta = {
        "window_strides": (stride, stride),
        "padding": pads,
        "lhs_dilation": (1, 1),
        "rhs_dilation": (dilation, dilation),
        "dimension_numbers": jax.lax.conv_dimension_numbers(
            (1, size, size, C), w_shape, ("NHWC", "HWIO", "NHWC")
        ),
        "feature_group_count": groups,
        "batch_group_count": 1,
        "w_shape": w_shape,
    }
    tmeta = {
        "stride": (stride, stride),
        "padding": pads,
        "kernel": (kernel, kernel),
        "dilation": (dilation, dilation),
        "groups": groups,
        "C": C,
        "w_shape": (O, C // groups, kernel, kernel),
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


# (C, kernel, stride, size, pads, dilation[, groups])
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
    (32, 3, 1, 8, None, 1, 2),  # groups
]


@pytest.mark.parametrize(
    "row", GATE_TABLE,
    ids=lambda r: f"C{r[0]}k{r[1]}s{r[2]}d{r[5]}" + (f"g{r[6]}" if len(r) > 6 else ""),
)
def test_gate_agrees_with_pallas_gate(row):
    C, kernel, stride, size, pads, dilation, *groups = row
    jmeta, tmeta = _metas(C, kernel, stride, size, pads, dilation, groups=(groups or [1])[0])
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


# ---------------------------------------------------------------------- #
# the kernel's arithmetic, emulated in plain torch
# ---------------------------------------------------------------------- #
TILE, SLAB = kernels._TILE, kernels._BK  # output tile edge; rows per short sum
EPC = 4  # float32 features per 16-byte chunk


def _truncated_f32(x: torch.Tensor) -> torch.Tensor:
    """float64 to float32 toward zero: how the tensor core's float32
    accumulator adds a product into its sum."""
    f = x.to(torch.float32)
    over = f.double().abs() > x.abs()
    return torch.where(over, torch.nextafter(f, torch.zeros_like(f)), f).double()


def _gather(x_nhwc: torch.Tensor, geo: dict, bias_pad, rows: int) -> torch.Tensor:
    """Rows ``[0, rows)`` of the patch matrix as the kernel gathers them, one
    16-byte chunk (4 features) at a time: a chunk below ``d_in`` is one run
    of ``EPC`` channels of one input pixel (``C % 8 == 0``), zero in the
    padding and on rows past ``R``; the bias-pad column and the features past
    it are written, not gathered. Columns padded to a whole tile."""
    B, H, W, C = x_nhwc.shape
    S, d_in = geo["Ho"] * geo["Wo"], geo["d_in"]
    d = d_in + (bias_pad is not None)
    r = torch.arange(rows)
    row_in = r < B * S
    b, s = (r // S).clamp(max=B - 1), r % S
    hbase = (s // geo["Wo"]) * geo["sh"] - geo["ph"]
    wbase = (s % geo["Wo"]) * geo["sw"] - geo["pw"]
    P = torch.zeros((rows, -(-d // TILE) * TILE))
    for f0 in range(0, min(d_in, P.shape[1]), EPC):
        kk, c = divmod(f0, C)
        ki, kj = divmod(kk, geo["kw"])
        h, w = hbase + ki, wbase + kj
        inside = row_in & (h >= 0) & (h < H) & (w >= 0) & (w < W)
        chunk = x_nhwc[b, h.clamp(0, H - 1), w.clamp(0, W - 1), c:c + EPC]
        P[:, f0:f0 + EPC] = torch.where(inside[:, None], chunk, 0.0)
    if bias_pad is not None:
        P[:, d_in] = torch.where(row_in, bias_pad, 0.0)
    return P


def _emulate_kernel(x: torch.Tensor, meta: dict, bias_pad, n_sms: int = 132,
                    slab: int = SLAB, splits_rows: tuple | None = None) -> torch.Tensor:
    """The kernel's result: the rows split as ``kernels._splits`` splits
    them, each split's sum over slabs of ``slab`` rows, each slab one short
    tensor-core sum per element (per 8-row k-step the products
    ``lo hi``, ``hi lo``, ``hi hi``, each added to the sum and truncated to
    float32), added to a float32 accumulator; the splits summed in order;
    the upper-triangle tiles kept and the tiles below read transposed."""
    geo = kernels._geometry(tuple(x.shape), meta)
    d = geo["d_in"] + (bias_pad is not None)
    R = geo["B"] * geo["Ho"] * geo["Wo"]
    tiles = -(-d // TILE)
    splits, rows = splits_rows or kernels._splits(tiles * (tiles + 1) // 2, R, n_sms)
    hi, lo = (t.double() for t in split_3xtf32(
        _gather(x.permute(0, 2, 3, 1).contiguous(), geo, bias_pad, splits * rows)
    ))
    cov = None
    for z in range(splits):
        acc = torch.zeros((hi.shape[1],) * 2)
        for r0 in range(z * rows, min((z + 1) * rows, R), slab):
            part = torch.zeros(acc.shape, dtype=torch.float64)
            for k0 in range(r0, r0 + slab, 8):
                for a, b in ((lo, hi), (hi, lo), (hi, hi)):
                    part = _truncated_f32(part + a[k0:k0 + 8].T @ b[k0:k0 + 8])
            acc = acc + part.float()
        cov = acc if cov is None else cov + acc
    cov = cov[:d, :d]
    i, j = torch.arange(d)[:, None], torch.arange(d)[None, :]
    return torch.where(i // TILE > j // TILE, cov.T, cov)


@pytest.mark.parametrize("bias", list(BIAS_PADS))
@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_kernel_emulation_matches_plain(geometry, bias):
    """The kernel's gather index map, tile and split decomposition and
    3xTF32 short-sum order, emulated, against the plain version: relative
    Frobenius error below 1e-6 (d = 144, 145 and 16, none a multiple of the
    64-wide tile; rows split in two slabs of 32 where there are 64)."""
    kernel, stride, size = GEOMETRIES[geometry]
    _, tmeta = _metas(16, kernel, stride, size)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((2, 16, size, size)).astype(np.float32))
    R = 2 * (size // stride) ** 2
    cov = _emulate_kernel(x, tmeta, BIAS_PADS[bias], splits_rows=(-(-R // 64), 64))
    plain, _ = kernels.conv_input_covariance_plain(x, tmeta, BIAS_PADS[bias])
    assert rel_fro(cov, plain.double()) < 1e-6


def _covariance_f64(x: torch.Tensor, meta: dict) -> torch.Tensor:
    """The covariance in float64 from the plain version's patches."""
    P = extract_conv_patches(x.double(), meta)
    P = P.reshape(-1, P.shape[-1])
    return P.T @ P


def test_short_sums_keep_the_truncation_small():
    """Why each slab is its own tensor-core sum: over one split of 4096 rows
    (512 k-steps), slabs of 32 rows (4 k-steps, the kernel's) stay within
    1e-6 of the float64 covariance, and the drift grows with the slab (128,
    512 rows) to ten times that and more for one sum over the whole split,
    as the tensor core truncates each of its adds."""
    _, tmeta = _metas(16, 1, 1, 8)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((64, 16, 8, 8)).astype(np.float32))
    exact = _covariance_f64(x, tmeta)
    slabs = (SLAB, 128, 512, 4096)
    errs = [
        rel_fro(_emulate_kernel(x, tmeta, None, slab=slab, splits_rows=(1, 4096)), exact)
        for slab in slabs
    ]
    assert errs[0] < 1e-6 and errs[-1] > 10 * errs[0], errs
    assert all(b > 2 * a for a, b in zip(errs, errs[1:])), errs


# ResNet-18's kernel convs at batch 512: (d, R)
RESNET18_CONVS = {"layer1": (576, 32768), "layer2": (1152, 8192), "layer3": (2304, 2048),
                  "layer4": (4608, 512)}


@pytest.mark.parametrize("layer", list(RESNET18_CONVS))
def test_splits_fill_the_card(layer):
    """On 132 SMs every ResNet-18 3x3 conv at batch 512 launches at least two
    CTAs per SM: few tiles and many rows (layer1: 45 tiles x 8 splits, one
    wave of three CTAs per SM) and many tiles and few rows (layer4: 2,628
    tiles x 1)."""
    d, R = RESNET18_CONVS[layer]
    tiles = -(-d // TILE)
    n_tiles = tiles * (tiles + 1) // 2
    splits, rows = kernels._splits(n_tiles, R, 132)
    assert n_tiles * splits >= 2 * 132
    assert rows % SLAB == 0 and (splits - 1) * rows < R <= splits * rows
