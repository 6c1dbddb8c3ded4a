"""The Hopper conv-covariance kernel on a CUDA device, against its plain version.

These tests need the card: they skip without one. The card's machine has no
JAX, so this file imports only the port, and runs there without the suite's
JAX-configuring ``conftest.py``::

    python -m pytest tests/test_torch_cuda.py -q --noconftest -p no:cacheprovider

TF32 is off in every test, so the plain version's matmul runs in float32.
"""

import pytest
import torch

from curvlinops_tpu_torch.kfac import kernels
from curvlinops_tpu_torch.kfac.operator import KFACLinearOperator
from curvlinops_tpu_torch.losses import CrossEntropyLoss
from curvlinops_tpu_torch.models.resnet import ResNet, same_pads

# (kernel, stride, input size): 3x3/s1 pads (1, 1); 3x3/s2 pads (0, 1), the
# asymmetric "SAME" case; 1x1/s2 pads (0, 0)
GEOMETRIES = {"3x3s1": (3, 1, 8), "3x3s2": (3, 2, 8), "1x1s2": (1, 2, 8)}


@pytest.fixture
def cuda():
    """The first CUDA device with TF32 off; skips without a card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


def _meta(C, kernel, stride, size):
    return {
        "stride": (stride, stride),
        "padding": (same_pads(size, kernel, stride),) * 2,
        "kernel": (kernel, kernel),
        "dilation": (1, 1),
        "groups": 1,
        "C": C,
        "w_shape": (8, C, kernel, kernel),
    }


def rel_err(a, b) -> float:
    return float((a.float() - b.float()).norm() / b.float().norm())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("bias_pad", [None, 1.0], ids=["nobias", "pad1"])
@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_kernel_matches_plain(cuda, geometry, bias_pad, dtype):
    """Relative Frobenius error below 1e-5 in float32 (summation order
    differs), below 1e-2 in bfloat16 (both round the float32 result to
    bfloat16)."""
    kernel, stride, size = GEOMETRIES[geometry]
    meta = _meta(64, kernel, stride, size)
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((32, 64, size, size), generator=gen).to(cuda, dtype)
    before = kernels.conv_input_covariance.launches
    cov, S = kernels.conv_input_covariance(x, meta, bias_pad)
    plain, plain_S = kernels.conv_input_covariance_plain(x, meta, bias_pad)
    torch.cuda.synchronize()
    assert kernels.conv_input_covariance.launches == before + 1
    assert S == plain_S and cov.dtype == dtype
    assert rel_err(cov, plain) < (1e-5 if dtype == torch.float32 else 1e-2)


@pytest.mark.cuda
def test_kernel_rejects_what_it_cannot_take(cuda):
    """On a CUDA tensor the wrapper launches or raises: it never computes
    the plain version instead."""
    x = torch.zeros((2, 8, 8, 8), device=cuda)  # C = 8 < 16
    with pytest.raises(ValueError, match="geometry"):
        kernels.conv_input_covariance(x, _meta(8, 3, 1, 8))
    x = torch.zeros((2, 16, 8, 8), device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError):
        kernels.conv_input_covariance(x, _meta(16, 3, 1, 8))


@pytest.mark.cuda
def test_kfac_factors_kernel_path_match_plain_path(cuda):
    """A narrow ResNet's KFAC input factors through the kernel agree with
    the plain path's (relative Frobenius error below 1e-5); every conv but
    the RGB stem launches the kernel."""
    gen = torch.Generator().manual_seed(0)
    model = ResNet("basic", (1, 1, 1, 1), (16, 16, 32, 32), 10, stem_width=16)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(0.2 * torch.randn(p.shape, generator=gen))
    model = model.to(cuda)
    X = torch.rand((4, 3, 16, 16), generator=gen).to(cuda)
    y = torch.randint(0, 10, (4,), generator=gen).to(cuda)
    params = {n: p for n, p in model.named_parameters() if "bn" not in n}
    ops = {}
    for use_kernel in (True, False):
        before = kernels.conv_input_covariance.launches
        ops[use_kernel] = KFACLinearOperator(
            model, CrossEntropyLoss("mean"), params, [(X, y)],
            fisher_type="type-2", use_kernel=use_kernel,
        )
        launches = kernels.conv_input_covariance.launches - before
        n_convs = sum(u.kind == "conv" for g in ops[use_kernel].groups for u in g.uses)
        assert launches == (n_convs - 1 if use_kernel else 0)
    for gi, aaT in ops[True]._aaT.items():
        assert rel_err(aaT, ops[False]._aaT[gi]) < 1e-5
