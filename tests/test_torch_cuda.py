"""The Hopper kernels on a CUDA device, against their plain versions.

The conv-covariance kernel (``kfac/kernels.py``) and the three flash-attention
kernels (``models/flash_attention.py``: forward, ``bwd_dkv``, ``bwd_dq``).

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
from curvlinops_tpu_torch.models import flash_attention as tfa
from curvlinops_tpu_torch.models import gpt as tgpt
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


# (B, C, size, kernel, stride): the two extremes of ResNet-18's convs and a
# channel count that is a multiple of 8 but not of 16
EXTREMES = {
    "few_tiles_many_rows": (512, 64, 8, 3, 1),  # d = 576: 45 tiles, 32,768 rows
    "many_tiles_few_rows": (128, 512, 1, 3, 1),  # d = 4,608: 2,628 tiles, 128 rows
    "C24": (16, 24, 9, 3, 2),  # d = 216, 16-byte chunks of 4 channels
}


def _extreme(case, device, dtype):
    B, C, size, kernel, stride = EXTREMES[case]
    gen = torch.Generator().manual_seed(7)
    x = torch.randn((B, C, size, size), generator=gen).relu().to(device, dtype)
    return x, _meta(C, kernel, stride, size)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("bias_pad", [None, 1.0], ids=["nobias", "pad1"])
@pytest.mark.parametrize("case", list(EXTREMES))
def test_kernel_matches_plain_at_the_extremes(cuda, case, bias_pad, dtype):
    """Few tiles over many rows (split over blockIdx.z), many tiles over few
    rows, and C = 24: relative Frobenius error below 1e-5 in float32, below
    1e-2 in bfloat16, as at the small geometries."""
    x, meta = _extreme(case, cuda, dtype)
    cov, S = kernels.conv_input_covariance(x, meta, bias_pad)
    plain, plain_S = kernels.conv_input_covariance_plain(x, meta, bias_pad)
    torch.cuda.synchronize()
    assert S == plain_S and cov.dtype == dtype
    assert rel_err(cov, plain) < (1e-5 if dtype == torch.float32 else 1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_kernel_is_deterministic(cuda, dtype):
    """Two calls on the same input give bitwise identical covariances: no
    atomics, the row splits summed in a fixed order."""
    x, meta = _extreme("few_tiles_many_rows", cuda, dtype)
    a, _ = kernels.conv_input_covariance(x, meta, 1.0)
    b, _ = kernels.conv_input_covariance(x, meta, 1.0)
    assert torch.equal(a, b)


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


# ---------------------------------------------------------------------- #
# flash attention
# ---------------------------------------------------------------------- #
def _qkv_do(shape, device, dtype, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn(shape, generator=gen).to(device, dtype) for _ in range(4)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize(
    "shape", [(2, 3, 200, 64), (1, 2, 1024, 64), (2, 2, 77, 16), (1, 3, 300, 32), (2, 2, 160, 128)],
    ids=["T200", "T1024", "T77hd16", "T300hd32", "T160hd128"],
)
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_flash_kernels_match_plain(cuda, shape, dtype, causal):
    """Each of the three kernels against its plain version, at ragged and
    full tiles: relative Frobenius error below 1e-4 in float32 (sums in
    another order), below 1e-2 in bfloat16 (both round float32 results to
    bfloat16, and the plain backward rounds its inputs' products again)."""
    q, k, v, do = _qkv_do(shape, cuda, dtype)
    scale = shape[-1] ** -0.5
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    o, lse = tfa.flash_attention_fwd_kernel(q, k, v, causal=causal, sm_scale=scale)
    o_ref, lse_ref = tfa.flash_attention_plain(q, k, v, causal=causal, sm_scale=scale)
    di = (o_ref.float() * do.float()).sum(-1)
    dk, dv = tfa.flash_attention_bwd_dkv_kernel(q, k, v, do, lse_ref, di, causal=causal, sm_scale=scale)
    dq = tfa.flash_attention_bwd_dq_kernel(q, k, v, do, lse_ref, di, causal=causal, sm_scale=scale)
    refs = tfa.flash_attention_bwd_plain(q, k, v, o_ref, lse_ref, do, causal=causal, sm_scale=scale)
    torch.cuda.synchronize()
    assert o.dtype == dtype and lse.dtype == torch.float32
    for name, a, b in (("o", o, o_ref), ("lse", lse, lse_ref), ("dq", dq, refs[0]),
                       ("dk", dk, refs[1]), ("dv", dv, refs[2])):
        assert rel_err(a, b) < tol, name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_flash_backward_kernels_are_deterministic(cuda, dtype):
    """Two calls of each backward kernel on the same inputs give bitwise
    identical ``dq``, ``dk`` and ``dv``: no atomics, a fixed summation order."""
    q, k, v, do = _qkv_do((2, 3, 333, 64), cuda, dtype, seed=3)
    o, lse = tfa.flash_attention_plain(q, k, v, causal=True, sm_scale=0.125)
    di = (o.float() * do.float()).sum(-1)
    args, kw = (q, k, v, do, lse, di), dict(causal=True, sm_scale=0.125)
    def grads():
        dk, dv = tfa.flash_attention_bwd_dkv_kernel(*args, **kw)
        return dk, dv, tfa.flash_attention_bwd_dq_kernel(*args, **kw)

    for name, a, b in zip(("dk", "dv", "dq"), grads(), grads()):
        assert torch.equal(a, b), name


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_flash_backward_kernels_large_logits(cuda, causal):
    """float32 with large scores: q scaled by 4 and k by 2 puts the scaled
    scores at standard deviation 8 (extremes past +-30), where the low TF32
    part of each split operand is small beside the high part; ``dq``, ``dk``
    and ``dv`` still agree with the plain version within 1e-4."""
    q, k, v, do = _qkv_do((2, 3, 256, 64), cuda, torch.float32, seed=4)
    q, k = 4 * q, 2 * k
    kw = dict(causal=causal, sm_scale=0.125)
    o, lse = tfa.flash_attention_plain(q, k, v, **kw)
    assert float((q @ k.transpose(-1, -2)).abs().max()) * 0.125 > 30
    di = (o * do).sum(-1)
    args = (q, k, v, do, lse, di)
    dk, dv = tfa.flash_attention_bwd_dkv_kernel(*args, **kw)
    dq = tfa.flash_attention_bwd_dq_kernel(*args, **kw)
    refs = tfa.flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
    for name, a, b in (("dq", dq, refs[0]), ("dk", dk, refs[1]), ("dv", dv, refs[2])):
        assert rel_err(a, b) < 1e-4, name


@pytest.mark.cuda
@pytest.mark.parametrize(
    "shape", [(2, 3, 1000, 64), (2, 3, 100, 32), (1, 2, 1000, 128), (2, 2, 100, 128)],
    ids=["T1000hd64", "T100hd32", "T1000hd128", "T100hd128"],
)
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_flash_forward_ragged_and_head_dims(cuda, shape, causal):
    """The forward kernel at ragged T (the last key and query tiles masked)
    and head dims 32, 64 and 128 (q kept in shared memory at 128): ``o`` and
    ``lse`` within 1e-4 of the plain version in float32."""
    q, k, v, _ = _qkv_do(shape, cuda, torch.float32, seed=5)
    kw = dict(causal=causal, sm_scale=shape[-1] ** -0.5)
    o, lse = tfa.flash_attention_fwd_kernel(q, k, v, **kw)
    o_ref, lse_ref = tfa.flash_attention_plain(q, k, v, **kw)
    assert rel_err(o, o_ref) < 1e-4 and rel_err(lse, lse_ref) < 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_flash_forward_kernel_is_deterministic(cuda, dtype):
    """Two forward calls give bitwise identical ``o`` and ``lse``."""
    q, k, v, _ = _qkv_do((2, 3, 333, 64), cuda, dtype, seed=6)
    kw = dict(causal=True, sm_scale=0.125)
    (o1, lse1), (o2, lse2) = (tfa.flash_attention_fwd_kernel(q, k, v, **kw) for _ in range(2))
    assert torch.equal(o1, o2) and torch.equal(lse1, lse2)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_flash_forward_large_logits(cuda, causal):
    """float32 with q scaled by 4 and k by 2 (scaled scores past +-30): the
    online softmax's rescales and the split products keep ``o`` and ``lse``
    within 1e-4 of the plain version."""
    q, k, v, _ = _qkv_do((2, 3, 256, 64), cuda, torch.float32, seed=4)
    q, k = 4 * q, 2 * k
    kw = dict(causal=causal, sm_scale=0.125)
    assert float((q @ k.transpose(-1, -2)).abs().max()) * 0.125 > 30
    o, lse = tfa.flash_attention_fwd_kernel(q, k, v, **kw)
    o_ref, lse_ref = tfa.flash_attention_plain(q, k, v, **kw)
    assert rel_err(o, o_ref) < 1e-4 and rel_err(lse, lse_ref) < 1e-4


@pytest.mark.cuda
def test_flash_function_launch_counters(cuda):
    """A forward and a backward through the Function launch each kernel once;
    a vmapped backward over 3 vectors launches each backward kernel once."""
    q, k, v, do = _qkv_do((1, 2, 96, 32), cuda, torch.float32)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    before = dict(tfa.launches)
    o = tfa.flash_attention(q, k, v, sm_scale=0.2)
    grads = torch.autograd.grad(o, (q, k, v), do, retain_graph=True)
    assert {n: tfa.launches[n] - before[n] for n in before} == {"fwd": 1, "bwd_dkv": 1, "bwd_dq": 1}
    dos = torch.stack([do, 2 * do, -do])
    batched = torch.func.vmap(lambda g: torch.autograd.grad(o, (q, k, v), g, retain_graph=True))(dos)
    assert {n: tfa.launches[n] - before[n] for n in before} == {"fwd": 1, "bwd_dkv": 2, "bwd_dq": 2}
    for g_b, g in zip(batched, grads):
        assert rel_err(g_b[1], 2 * g) < 1e-5


@pytest.mark.cuda
def test_flash_kernels_refuse_what_they_cannot_take(cuda):
    """On a CUDA tensor the Function launches or raises: never the plain
    version instead."""
    x = torch.zeros((1, 1, 16, 64), device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError):
        tfa.flash_attention(x, x, x, sm_scale=0.125)
    with pytest.raises(TypeError):
        tfa.flash_attention(x.double(), x.double(), x.double(), sm_scale=0.125)
    with pytest.raises(ValueError, match="Head dim"):
        y = torch.zeros((1, 1, 16, 48), device=cuda)
        tfa.flash_attention(y, y, y, sm_scale=0.125)
    with pytest.raises(ValueError):
        y = torch.zeros((16, 64), device=cuda)
        tfa.flash_attention(y, y, y, sm_scale=0.125)
    with pytest.raises(ValueError, match="16-byte"):  # contiguous, but 4 bytes past an alignment
        y = torch.zeros(16 * 64 + 1, device=cuda)[1:].view(1, 1, 16, 64)
        tfa.flash_attention(y, y, y, sm_scale=0.125)


@pytest.mark.cuda
def test_gpt_kfac_flash_matches_einsum(cuda):
    """A small GPT's KFAC factors (empirical Fisher) through the flash
    kernels agree with the einsum path's (relative Frobenius error below
    1e-4), and each layer launches each kernel."""
    config = tgpt.GPTConfig(block_size=200, vocab_size=64, n_layer=2, n_head=2, n_embd=64)
    ops = {}
    for impl in ("flash", "einsum"):
        problem = tgpt.shakespeare_nanogpt(batch_size=2, config=config, device=cuda, attention_impl=impl)
        before = dict(tfa.launches)
        ops[impl] = KFACLinearOperator(
            problem.model, problem.loss_fn, problem.kfac_params, problem.data,
            fisher_type="empirical",
        )
        launched = {n: tfa.launches[n] - before[n] for n in before}
        # forwards: layer discovery, the determinism probe's two passes and
        # the factor pass; backwards: the last three
        L = config.n_layer
        expected = {"fwd": 4 * L, "bwd_dkv": 3 * L, "bwd_dq": 3 * L}
        assert launched == (expected if impl == "flash" else dict.fromkeys(before, 0))
    for gi, ggT in ops["flash"]._ggT.items():
        assert rel_err(ggT, ops["einsum"]._ggT[gi]) < 1e-4
    for gi, aaT in ops["flash"]._aaT.items():
        assert rel_err(aaT, ops["einsum"]._aaT[gi]) < 1e-4
