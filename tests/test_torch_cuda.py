"""The Hopper kernels on a CUDA device, against their plain versions.

The conv-covariance kernel (``kfac/kernels.py``) and the three flash-attention
kernels (``models/flash_attention.py``: forward, ``bwd_dkv``, ``bwd_dq``),
including a launch on a second device; the curvature operators of
``risk.py`` (which reach no port kernel) on the card against the CPU, their
multi-batch accumulation, and the flash GPT's refusal of forward mode; and
the solvers (CG, MINRES, LSMR, fast Lanczos, LOBPCG) on the card against
the CPU, and the Neumann series' divergence on the card; the rest of the
KFAC family (REDUCE, the rank-r inverse, EKFAC, KFOC) on the card against
the CPU, and the randomized range finder under a user's ``allow_tf32``; each
estimator's core, the exact GGN diagonal and the held linearizations on the
card; the transformer family: the stacked flash GPT's kernel launches and
factors against the unrolled GPT's, KFAC and EKFAC on the stacked GPT with
embeddings and the stacked ViT against the CPU, and the fused GPT's GGN
through SDPA's pinned backend under forward mode; the collector's
function-level uses: bias-only KFAC against the full KFAC's bias blocks and
an MLP in HuggingFace's ``Conv1D`` layout against its ``nn.Linear`` form,
each on the card against the CPU, and the flash GPT with ``Conv1D`` layers,
whose ``addmm`` taps feed the flash kernels' factor pass; data parallelism
(a one-process NCCL mesh, and a two-process one on two cards) and the
prefetching pipeline's pinned copies on a side stream; the captured
programs: each curvature operator's fused matmat and the fused gradient
against the streamed loop (one batch, uniform and ragged batches), MC
replays that draw the same samples, outputs not aliased between calls, a
Neumann series and fast Lanczos capturing a fused GGN inline, the same
over a streamed MC GGN (resident or prefetched) running eagerly, an epoch
bump freeing the graphs' pool, and a capture that cannot succeed raising;
the captured solvers: the masked chunked loop (stops at a chunk's edges,
one host read a replay), CG, MINRES, LSMR and LOBPCG captured against
eager, the small-eigh kernel against ``torch.linalg.eigh`` (to n = 512, by
both of its routes), LOBPCG at k = 33 and 40 captured and eager and past
the kernel's limit, each class marked ``capturable`` inside a Neumann
series, and a step that reads the host raising with the program's name;
the bfloat16 paths: KFAC's conv factors from the kernel positive
semi-definite (an exact-damped inverse bounded), and the GPT under forward
mode.

These tests need the card: they skip without one. The card's machine has no
JAX, so this file imports only the port, and runs there without the suite's
JAX-configuring ``conftest.py``::

    python -m pytest tests/test_torch_cuda.py -q --noconftest -p no:cacheprovider

TF32 is off in every test, so the plain version's matmul runs in float32.
"""

import pytest
import torch

from curvlinops_tpu_torch import (
    EFLinearOperator,
    GGNLinearOperator,
    HessianLinearOperator,
    JacobianLinearOperator,
    PrefetchToDevice,
    TransposedJacobianLinearOperator,
)
from curvlinops_tpu_torch.kfac import kernels
from curvlinops_tpu_torch.kfac.operator import KFACLinearOperator
from curvlinops_tpu_torch.losses import CrossEntropyLoss
from curvlinops_tpu_torch.models import flash_attention as tfa
from curvlinops_tpu_torch.models import gpt as tgpt
from curvlinops_tpu_torch.models import mlp as tmlp
from curvlinops_tpu_torch.models import resnet as tresnet
from curvlinops_tpu_torch.models.resnet import ResNet, cifar10_resnet18, same_pads

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
    """Relative Frobenius error, computed in float64 (a float64 comparison
    keeps its digits)."""
    return float((a.double() - b.double()).norm() / b.double().norm())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("bias_pad", [None, 1.0], ids=["nobias", "pad1"])
@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_kernel_matches_plain(cuda, geometry, bias_pad, dtype):
    """Relative Frobenius error below 1e-5 for either input type: both
    sides sum products exact in TF32 (bfloat16 inputs included) in float32,
    in another order; the covariance is float32 for either input type."""
    kernel, stride, size = GEOMETRIES[geometry]
    meta = _meta(64, kernel, stride, size)
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((32, 64, size, size), generator=gen).to(cuda, dtype)
    before = kernels.conv_input_covariance.launches
    cov, S = kernels.conv_input_covariance(x, meta, bias_pad)
    plain, plain_S = kernels.conv_input_covariance_plain(x, meta, bias_pad)
    torch.cuda.synchronize()
    assert kernels.conv_input_covariance.launches == before + 1
    assert S == plain_S and cov.dtype == plain.dtype == torch.float32
    assert rel_err(cov, plain) < 1e-5


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
    rows, and C = 24: relative Frobenius error below 1e-5 for either input
    type, as at the small geometries; float32 out."""
    x, meta = _extreme(case, cuda, dtype)
    cov, S = kernels.conv_input_covariance(x, meta, bias_pad)
    plain, plain_S = kernels.conv_input_covariance_plain(x, meta, bias_pad)
    torch.cuda.synchronize()
    assert S == plain_S and cov.dtype == plain.dtype == torch.float32
    assert rel_err(cov, plain) < 1e-5


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


@pytest.mark.cuda
def test_bf16_kfac_conv_factors_psd_and_exact_inverse_bounded_on_card(cuda):
    """A bfloat16 narrow ResNet (BatchNorm calibrated on its 8 images),
    type-2 KFAC through the kernel: the kernel's covariances are float32
    sums, not rounded to bfloat16, so every conv input factor is float32
    and positive semi-definite to float32 rounding (smallest eigenvalue
    above -1e-5 of the largest; rounded to bfloat16 they reach -1e-4 and
    below), and the exact-damped inverse (damping 0.1) maps a vector to at
    most 1 / 0.1 of its norm, as ``(K + 0.1 I)^-1`` of a PSD ``K`` must
    (with the factors rounded, a ``[16 x 144]`` block's output grew 53-fold
    past its float32 twin's)."""
    gen = torch.Generator().manual_seed(0)
    model = ResNet("basic", (1, 1, 1, 1), (16, 16, 32, 32), 10, stem_width=16)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(0.2 * torch.randn(p.shape, generator=gen))
    model = model.to(cuda, torch.bfloat16)
    X = torch.rand((8, 3, 16, 16), generator=gen).to(cuda, torch.bfloat16)
    y = torch.randint(0, 10, (8,), generator=gen).to(cuda)
    model.load_state_dict(tresnet.calibrate_bn(model, X), strict=False)
    params = {n: p for n, p in model.named_parameters() if "bn" not in n}
    before = kernels.conv_input_covariance.launches
    kfac = KFACLinearOperator(model, CrossEntropyLoss("mean"), params, [(X, y)],
                              fisher_type="type-2", check_deterministic=False)
    assert kernels.conv_input_covariance.launches - before == 11  # all convs but the stem
    for gi, aaT in kfac._aaT.items():
        assert aaT.dtype == torch.float32
        w = torch.linalg.eigvalsh(aaT.double())
        assert float(w[0]) >= -1e-5 * float(w[-1]), kfac.groups[gi].name
    inv = kfac.inverse(damping=0.1, use_exact_damping=True)
    v = {n: torch.randn(p.shape, generator=gen).to(cuda, torch.bfloat16) for n, p in params.items()}
    out = inv @ v
    assert all(t.dtype == torch.bfloat16 for t in out.values())
    norm = lambda tree: float(torch.cat([t.float().reshape(-1) for t in tree.values()]).norm())  # noqa: E731
    assert norm(out) <= 1.02 * norm(v) / 0.1


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["ggn", "hessian"])
def test_bf16_gpt_forward_mode_on_card(cuda, op):
    """The bfloat16 einsum GPT (``TINY_GPT``) under forward mode on the card:
    the GGN and Hessian matvecs run (CUDA's fused LayerNorm once gave its
    output a float32 tangent, which the next bfloat16 layer refused), stay
    bfloat16 and finite, and lie within 5e-2 of the float32 twin's (the
    same bfloat16-valued weights)."""
    import copy

    from curvlinops_tpu_torch import HessianLinearOperator

    p = tgpt.shakespeare_nanogpt(2, tgpt.TINY_GPT, seed=0, dtype=torch.bfloat16, device=cuda,
                                 attention_impl="einsum")
    twin = copy.deepcopy(p.model).float()
    cls = {"ggn": GGNLinearOperator, "hessian": HessianLinearOperator}[op]
    gen = torch.Generator().manual_seed(3)
    v = {n: torch.randn(t.shape, generator=gen).to(cuda) for n, t in p.params.items()}
    outs = []
    for model, dtype in ((p.model, torch.bfloat16), (twin, torch.float32)):
        A = cls(model, CrossEntropyLoss("mean"), dict(model.named_parameters()), p.data,
                check_deterministic=False)
        outs.append(A @ {n: t.to(torch.bfloat16).to(dtype) for n, t in v.items()})
    assert all(t.dtype == torch.bfloat16 and bool(t.isfinite().all()) for t in outs[0].values())
    flat = [torch.cat([o[n].double().reshape(-1) for n in v]) for o in outs]
    assert float((flat[0] - flat[1]).norm() / flat[1].norm()) < 5e-2


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


# ---------------------------------------------------------------------- #
# the empirical-risk curvature operators on the card (no port kernel)
# ---------------------------------------------------------------------- #
CURVATURE = {
    "ggn": lambda m, loss, p, d: GGNLinearOperator(m, loss, p, d),
    "hessian": lambda m, loss, p, d: HessianLinearOperator(m, loss, p, d),
    "ef": lambda m, loss, p, d: EFLinearOperator(m, loss, p, d),
    "jacobian": lambda m, loss, p, d: JacobianLinearOperator(m, p, d),
    "jacobian_t": lambda m, loss, p, d: TransposedJacobianLinearOperator(m, p, d),
}


@pytest.mark.cuda
@pytest.mark.parametrize("op", list(CURVATURE))
@pytest.mark.parametrize("model", ["mlp", "resnet"])
def test_curvature_operator_card_matches_cpu(cuda, model, op):
    """The same operator code on the card and on the CPU, float64: a tiny
    MLP and a narrow ResNet, relative Frobenius error of ``A @ V`` below
    1e-10."""
    make = tmlp.tiny_mlp_problem if model == "mlp" else tresnet.narrow_resnet_problem
    A_cpu = CURVATURE[op](*_args(make(device="cpu")))
    A_card = CURVATURE[op](*_args(make(device=cuda)))
    V = torch.randn((A_cpu.shape[1], 3), generator=torch.Generator().manual_seed(0),
                    dtype=torch.float64)
    on_cpu = A_cpu @ V
    assert rel_err((A_card @ V.to(cuda)).cpu(), on_cpu) < 1e-10


def _args(problem):
    return problem.model, problem.loss_fn, problem.params, problem.data


@pytest.mark.cuda
def test_ggn_accumulates_batches_on_card(cuda):
    """ResNet-18 at full width, B=32: the same data as 2 batches of 16 gives
    the GGN matvec of 1 batch of 32 (relative error below 1e-4, float32)."""
    problem = cifar10_resnet18(batch_size=32, device=cuda)
    X, y = problem.data[0]
    args = (problem.model, problem.loss_fn, problem.params)
    one = GGNLinearOperator(*args, problem.data, check_deterministic=False)
    two = GGNLinearOperator(*args, list(zip(X.chunk(2), y.chunk(2))), check_deterministic=False)
    v = torch.randn(one.shape[1], generator=torch.Generator().manual_seed(0)).to(cuda)
    assert rel_err(two @ v, one @ v) < 1e-4


@pytest.mark.cuda
def test_flash_gpt_refuses_forward_mode_on_card(cuda):
    """The determinism probe's reverse pass runs the kernels (head dim 16);
    its matvec's forward mode raises the refusal."""
    config = tgpt.GPTConfig(block_size=32, vocab_size=64, n_layer=2, n_head=2, n_embd=32)
    problem = tgpt.shakespeare_nanogpt(batch_size=2, config=config, device=cuda,
                                       attention_impl="flash")
    with pytest.raises(NotImplementedError) as err:
        GGNLinearOperator(problem.model, problem.loss_fn, problem.params, problem.data)
    assert str(err.value) == tfa.FORWARD_MODE_REFUSAL


@pytest.mark.cuda
def test_kernels_launch_on_the_tensors_device(cuda):
    """Inputs on ``cuda:1`` while device 0 is current: each kernel runs on
    the inputs' device and agrees with its plain version there."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    dev = torch.device("cuda:1")
    assert torch.cuda.current_device() == 0
    gen = torch.Generator().manual_seed(0)
    meta = _meta(64, 3, 1, 8)
    x = torch.randn((8, 64, 8, 8), generator=gen).to(dev)
    cov, _ = kernels.conv_input_covariance(x, meta)
    plain, _ = kernels.conv_input_covariance_plain(x, meta)
    assert cov.device == dev and rel_err(cov, plain) < 1e-5
    q, k, v, do = (torch.randn((1, 2, 64, 64), generator=gen).to(dev) for _ in range(4))
    kw = dict(causal=True, sm_scale=0.125)
    o, lse = tfa.flash_attention_fwd_kernel(q, k, v, **kw)
    o_ref, lse_ref = tfa.flash_attention_plain(q, k, v, **kw)
    di = (o_ref * do).sum(-1)
    dk, dv = tfa.flash_attention_bwd_dkv_kernel(q, k, v, do, lse_ref, di, **kw)
    dq = tfa.flash_attention_bwd_dq_kernel(q, k, v, do, lse_ref, di, **kw)
    dk_ref, dv_ref = tfa.flash_attention_bwd_dkv_plain(q, k, v, do, lse_ref, di, **kw)
    dq_ref = tfa.flash_attention_bwd_dq_plain(q, k, v, do, lse_ref, di, **kw)
    torch.cuda.synchronize(dev)
    assert torch.cuda.current_device() == 0
    for a, b in ((o, o_ref), (lse, lse_ref), (dk, dk_ref), (dv, dv_ref), (dq, dq_ref)):
        assert a.device == dev and rel_err(a, b) < 1e-5


# ---------------------------------------------------------------------- #
# the solvers and inverse operators on the card (no port kernel)
# ---------------------------------------------------------------------- #
def _solve(solver: str, problem, V: torch.Tensor) -> torch.Tensor:
    """One solver on a problem's damped GGN (LSMR: its Jacobian), 8 steps
    from the given columns, as a flat tensor."""
    from curvlinops_tpu_torch import (
        CGInverseLinearOperator,
        IdentityLinearOperator,
        LSMRInverseLinearOperator,
        MINRESInverseLinearOperator,
    )
    from curvlinops_tpu_torch.solvers.lanczos import fast_lanczos

    model, loss, params, data = _args(problem)
    if solver == "lsmr":
        J = JacobianLinearOperator(model, params, data)
        return LSMRInverseLinearOperator(J, maxiter=8, atol=0.0, btol=0.0) @ V[: J.shape[0]]
    G = GGNLinearOperator(model, loss, params, data)
    A = G + 0.1 * IdentityLinearOperator(G.in_spec)
    if solver == "lanczos":
        evals, evecs = fast_lanczos(A, 8, v0=V[:, 0])
        return torch.cat([evals, evecs.abs().reshape(-1)])
    cls = CGInverseLinearOperator if solver == "cg" else MINRESInverseLinearOperator
    return cls(A, maxiter=8, tol=0.0, atol=0.0) @ V


@pytest.mark.cuda
@pytest.mark.parametrize("solver", ["cg", "minres", "lsmr", "lanczos"])
def test_solver_card_matches_cpu(cuda, solver):
    """The tiny MLP (float64), the same start columns: 8 iterations on the
    card against the CPU to 1e-10 relative."""
    cpu, card = tmlp.tiny_mlp_problem(device="cpu"), tmlp.tiny_mlp_problem(device=cuda)
    n = GGNLinearOperator(*_args(cpu)).shape[0]
    V = torch.randn((n, 2), generator=torch.Generator().manual_seed(0), dtype=torch.float64)
    on_cpu = _solve(solver, cpu, V)
    on_card = _solve(solver, card, V.to(cuda))
    assert on_card.device.type == "cuda"
    assert rel_err(on_card.cpu(), on_cpu) < 1e-10


@pytest.mark.cuda
def test_lobpcg_and_neumann_on_card(cuda):
    """LOBPCG on a dense SPD matrix on the card against the CPU (float64,
    one start block), and the Neumann series' divergence raised on the card."""
    from curvlinops_tpu_torch import MatrixLinearOperator, NeumannInverseLinearOperator
    from curvlinops_tpu_torch.solvers.eigsh import lobpcg_standard

    gen = torch.Generator().manual_seed(0)
    A = torch.randn((40, 40), generator=gen, dtype=torch.float64)
    A = A @ A.T / 40 + torch.eye(40, dtype=torch.float64)
    X0 = torch.randn((40, 3), generator=gen, dtype=torch.float64)
    theta_cpu, U_cpu, _ = lobpcg_standard(A, X0, m=6)
    theta, U, _ = lobpcg_standard(A.to(cuda), X0.to(cuda), m=6)
    assert U.device.type == "cuda"
    assert rel_err(theta.cpu(), theta_cpu) < 1e-10 and rel_err(U.abs().cpu(), U_cpu.abs()) < 1e-8
    inv = NeumannInverseLinearOperator(MatrixLinearOperator(5 * torch.eye(4, device=cuda)),
                                       num_terms=200)
    with pytest.raises(ValueError, match="diverged"):
        inv @ torch.ones(4, device=cuda)


# ---------------------------------------------------------------------- #
# the rest of the KFAC family on the card
# ---------------------------------------------------------------------- #
def _kfac_case(make, device):
    """A problem with an ``nn.Module`` and one batch: the narrow ResNet, or
    the tiny MLP as :func:`~curvlinops_tpu_torch.models.mlp.mlp_module` on
    its first batch."""
    problem = make(device=device)
    if make is tmlp.tiny_mlp_problem:
        model = tmlp.mlp_module(problem.params)
        return model, dict(model.named_parameters()), problem.data[:1]
    return problem.model, problem.kfac_params, problem.data


def _family_apply(family, model, params, data, V):
    """One operator of the family built type-2 and applied to ``V``."""
    from curvlinops_tpu_torch import EKFACLinearOperator, KFOCLinearOperator

    kw = dict(fisher_type="type-2", check_deterministic=False)
    loss = CrossEntropyLoss("mean")
    if family == "reduce":
        A = KFACLinearOperator(model, loss, params, data, kfac_approx="reduce", **kw)
    elif family == "rank":
        A = KFACLinearOperator(model, loss, params, data, **kw).inverse(
            damping=0.1, use_exact_damping=True, rank=4
        )
    elif family.startswith("ekfac"):
        A = EKFACLinearOperator(model, loss, params, data,
                                rank=4 if family == "ekfac_rank" else None, **kw)
    else:
        A = KFOCLinearOperator(model, loss, params, data, **kw)
    return A @ V


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["reduce", "rank", "ekfac", "ekfac_rank", "kfoc"])
@pytest.mark.parametrize("model", ["mlp", "resnet"])
def test_kfac_family_card_matches_cpu(cuda, model, family):
    """REDUCE, ``inverse(rank=4)``, EKFAC (exact and rank 4) and KFOC built
    by the same code on the card and on the CPU, float64 (the rank-r test
    matrices drawn on the CPU for both): ``A @ V`` to 1e-10 relative."""
    make = tmlp.tiny_mlp_problem if model == "mlp" else tresnet.narrow_resnet_problem
    on = {}
    for dev in ("cpu", cuda):
        m, params, data = _kfac_case(make, dev)
        n = sum(p.numel() for p in params.values())
        V = torch.randn((n, 2), generator=torch.Generator().manual_seed(0), dtype=torch.float64)
        on[str(dev)] = _family_apply(family, m, params, data, V.to(dev)).cpu()
    assert rel_err(on[str(cuda)], on["cpu"]) < 1e-10


@pytest.mark.cuda
def test_randomized_range_finder_ignores_user_tf32(cuda):
    """A user's ``allow_tf32 = True``: the range-finder and core products
    still run in float32 (the same bases as with TF32 off, to 1e-6; the
    basis orthonormal to 1e-4, where TF32 products would leave ~1e-3), and
    the user's setting is back after the call."""
    from curvlinops_tpu_torch.kfac.randomized import batched_randomized_eigh

    gen = torch.Generator().manual_seed(0)
    B = torch.randn((512, 512), generator=gen) / 512**0.5
    S = ((B * (1.0 + torch.arange(512.0)) ** -2) @ B.T).to(cuda)
    out = {}
    for tf32 in (False, True):
        torch.backends.cuda.matmul.allow_tf32 = tf32
        out[tf32] = batched_randomized_eigh({0: S}, 64, torch.Generator().manual_seed(1))[0]
        assert torch.backends.cuda.matmul.allow_tf32 is tf32
    torch.backends.cuda.matmul.allow_tf32 = False  # the checks in float32
    (lam0, U0, t0), (lam1, U1, t1) = out[False], out[True]
    assert rel_err(lam1, lam0) < 1e-6 and rel_err(U1 @ U1.T, U0 @ U0.T) < 1e-6
    assert float((U1.T @ U1 - torch.eye(64, device=cuda)).abs().max()) < 1e-4


# ---------------------------------------------------------------------- #
# the estimators, the GGN diagonal and the held linearizations on the card
# ---------------------------------------------------------------------- #
def _estimate(name: str, A, P: torch.Tensor) -> torch.Tensor:
    """One estimator's core on ``A`` and the probe columns of ``P``."""
    from curvlinops_tpu_torch.estimators import diagonal, norm, slq, trace

    return {
        "hutchinson_trace": lambda: trace.hutchinson_trace_core(A, P),
        "hutchpp_trace": lambda: trace.hutchpp_trace_core(A, P[:, :3], P[:, 3:6]),
        "xtrace": lambda: trace.xtrace_core(A, P[:, :4]),
        "hutchinson_diag": lambda: diagonal.hutchinson_diag_core(A, P),
        "xdiag": lambda: diagonal.xdiag_core(A, P[:, :4]),
        "hutchinson_squared_fro": lambda: norm.hutchinson_squared_fro_core(A, P),
        "slq_logdet": lambda: slq.slq_function_trace_core(A, torch.log, P[:, :4], 6),
    }[name]()


@pytest.mark.cuda
@pytest.mark.parametrize(
    "name",
    ["hutchinson_trace", "hutchpp_trace", "xtrace", "hutchinson_diag", "xdiag",
     "hutchinson_squared_fro", "slq_logdet"],
)
def test_estimator_core_card_matches_cpu(cuda, name):
    """Each estimator's core on the tiny MLP's GGN + 0.1 I (float64), the
    same +-1 probes: the card against the CPU to 1e-10 relative."""
    from curvlinops_tpu_torch import IdentityLinearOperator

    on = {}
    for dev in ("cpu", cuda):
        G = GGNLinearOperator(*_args(tmlp.tiny_mlp_problem(device=dev)))
        bits = torch.randint(0, 2, (G.shape[1], 8), generator=torch.Generator().manual_seed(0))
        P = (2 * bits - 1).double().to(dev)
        out = _estimate(name, G + 0.1 * IdentityLinearOperator(G.in_spec), P)
        assert out.device.type == torch.device(dev).type
        on[str(dev)] = out.cpu()
    assert rel_err(on[str(cuda)], on["cpu"]) < 1e-10


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["ggn", "mc", "hessian", "ef"])
def test_held_matvec_on_card(cuda, op):
    """The held operator on the narrow ResNet (float64) on the card: its
    matvec equals the base's to 1e-10 and calls no module."""
    problem = tresnet.narrow_resnet_problem(device=cuda)
    cls = {"ggn": GGNLinearOperator, "mc": GGNLinearOperator,
           "hessian": HessianLinearOperator, "ef": EFLinearOperator}[op]
    kw = {"mc_samples": 2} if op == "mc" else {}
    base = cls(*_args(problem), check_deterministic=False, **kw)
    held = base.linearized()
    calls = []
    hooks = [m.register_forward_hook(lambda *_: calls.append(1)) for m in problem.model.modules()]
    V = torch.randn((base.shape[1], 2), generator=torch.Generator().manual_seed(0),
                    dtype=torch.float64).to(cuda)
    out = held @ V
    for h in hooks:
        h.remove()
    assert out.device == V.device and not calls
    assert rel_err(out, base @ V) < 1e-10


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["mlp", "resnet"])
def test_ggn_diagonal_card_matches_cpu(cuda, model):
    """The exact GGN diagonal (float64) on the card against the CPU, 1e-10."""
    from curvlinops_tpu_torch import GGNDiagonalLinearOperator

    make = tmlp.tiny_mlp_problem if model == "mlp" else tresnet.narrow_resnet_problem
    on = {}
    for dev in ("cpu", cuda):
        diag = GGNDiagonalLinearOperator(*_args(make(device=dev))).diagonal
        leaves = torch.utils._pytree.tree_leaves(diag)
        assert all(t.device.type == torch.device(dev).type for t in leaves)
        on[str(dev)] = torch.cat([t.reshape(-1).cpu() for t in leaves])
    assert rel_err(on[str(cuda)], on["cpu"]) < 1e-10


# ---------------------------------------------------------------------- #
# the transformer family on the card
# ---------------------------------------------------------------------- #
_STACKED_GPT = tgpt.GPTConfig(block_size=64, vocab_size=96, n_layer=3, n_head=2, n_embd=32)


@pytest.mark.cuda
def test_stacked_flash_gpt_launches_and_factors_on_card(cuda):
    """KFAC on the stacked flash GPT with embeddings launches each flash
    kernel at least once per layer (head dim 16), and its factors equal the
    unrolled flash GPT's slice by slice."""
    ops = {}
    for scan_blocks in (True, False):
        problem = tgpt.shakespeare_nanogpt(
            batch_size=2, config=_STACKED_GPT, device=cuda, attention_impl="flash",
            scan_blocks=scan_blocks, include_embeddings=True,
        )
        for n in tfa.launches:
            tfa.launches[n] = 0
        ops[scan_blocks] = KFACLinearOperator(
            problem.model, problem.loss_fn, problem.kfac_params, problem.data,
            fisher_type="mc",
        )
        if scan_blocks:
            assert min(tfa.launches.values()) >= _STACKED_GPT.n_layer, tfa.launches
    stacked, unrolled = ops[True], ops[False]
    index = {g.key: gi for gi, g in enumerate(unrolled.groups)}
    for gi, g in enumerate(stacked.groups):
        for l in range(g.stack or 1):
            key = tuple(None if n is None else n.replace("h.", f"h{l}.", 1) for n in g.key)
            for mine, theirs in ((stacked._aaT, unrolled._aaT), (stacked._ggT, unrolled._ggT)):
                if gi in mine:
                    a = mine[gi][l] if g.stack else mine[gi]
                    assert rel_err(a, theirs[index[key]]) < 1e-5, (g.name, l)


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["kfac", "ekfac"])
@pytest.mark.parametrize("model", ["gpt", "vit"])
def test_transformer_kfac_card_matches_cpu(cuda, model, op):
    """KFAC and EKFAC (type-2, float64) on the tiny stacked GPT with
    embeddings and the tiny stacked ViT: the card against the CPU."""
    from curvlinops_tpu_torch.kfac.ekfac import EKFACLinearOperator
    from curvlinops_tpu_torch.models import vit as tvit

    def build(device):
        if model == "gpt":
            return tgpt.shakespeare_nanogpt(2, tgpt.TINY_GPT, dtype=torch.float64, device=device,
                                            scan_blocks=True, include_embeddings=True)
        return tvit.cifar10_vit(8, tvit.TINY_VIT, dtype=torch.float64, device=device,
                                scan_blocks=True)

    cls = KFACLinearOperator if op == "kfac" else EKFACLinearOperator
    out = []
    for device in ("cpu", cuda):
        p = build(device)
        A = cls(p.model, p.loss_fn, p.kfac_params, p.data, fisher_type="type-2",
                check_deterministic=False)
        V = torch.randn((A.shape[1], 2), generator=torch.Generator().manual_seed(7),
                        dtype=torch.float64)
        out.append((A @ V.to(device)).cpu())
    assert rel_err(out[1], out[0]) < 1e-10


@pytest.mark.cuda
def test_fused_gpt_ggn_under_forward_mode_on_card(cuda):
    """The fused GPT's GGN (forward mode through SDPA's pinned math
    backend) equals the einsum GPT's on the card."""
    out = []
    for impl in ("fused", "einsum"):
        p = tgpt.shakespeare_nanogpt(batch_size=2, config=_STACKED_GPT, device=cuda,
                                     attention_impl=impl, scan_blocks=True)
        G = GGNLinearOperator(p.model, p.loss_fn, p.params, p.data)
        v = torch.randn(G.shape[1], generator=torch.Generator().manual_seed(3)).to(cuda)
        out.append(G @ v)
    assert rel_err(out[0], out[1]) < 1e-5


# ---------------------------------------------------------------------- #
# the collector's bias-only groups and HuggingFace's Conv1D layout
# ---------------------------------------------------------------------- #
class _Conv1D(torch.nn.Module):
    """HuggingFace GPT-2's ``Conv1D``: ``weight [in, out]``, ``addmm`` on the
    rows of ``x``; built from an ``nn.Linear`` (its weight transposed)."""

    def __init__(self, linear):
        super().__init__()
        self.nf = linear.out_features
        self.weight = torch.nn.Parameter(linear.weight.detach().T.contiguous())
        self.bias = torch.nn.Parameter(linear.bias.detach().clone())

    def forward(self, x):  # noqa: D102
        out = torch.addmm(self.bias, x.view(-1, x.size(-1)), self.weight)
        return out.view(*x.shape[:-1], self.nf)


def _conv1d_layout(model):
    """Every ``nn.Linear`` of ``model`` swapped for a ``Conv1D``, in place."""
    for name, mod in list(model.named_modules()):
        for child, sub in list(mod.named_children()):
            if type(sub) is torch.nn.Linear and sub.bias is not None:
                setattr(mod, child, _Conv1D(sub))
    return model


def _seq_mlp(device, seed=0):
    """A tanh MLP 6 -> 8 -> 3 over ``[4, 5, 6]`` sequences, float64, MSE."""
    gen = torch.Generator().manual_seed(seed)
    model = torch.nn.Sequential(torch.nn.Linear(6, 8), torch.nn.Tanh(), torch.nn.Linear(8, 3))
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn(p.shape, generator=gen))
    X, y = torch.randn(4, 5, 6, generator=gen), torch.randn(4, 5, 3, generator=gen)
    return model.double().to(device), [(X.double().to(device), y.double().to(device))]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["bias_only", "conv1d"])
def test_collector_function_uses_card_matches_cpu(cuda, case):
    """Bias-only KFAC (equal to the full KFAC's bias blocks) and the MLP in
    the ``Conv1D`` layout (equal to the ``nn.Linear`` MLP at the transposed
    vector): float64, type-2, the card against the CPU to 1e-12."""
    from curvlinops_tpu_torch.losses import MSELoss

    out = {}
    for device in ("cpu", cuda):
        model, data = _seq_mlp(device)
        params = dict(model.named_parameters())
        full = KFACLinearOperator(model, MSELoss("mean"), params, data, fisher_type="type-2")
        if case == "bias_only":
            biases = {n: p for n, p in params.items() if n.endswith("bias")}
            op = KFACLinearOperator(model, MSELoss("mean"), biases, data, fisher_type="type-2")
            v = {n: torch.ones_like(p) for n, p in biases.items()}
            ref = full @ {n: v.get(n, torch.zeros_like(p)) for n, p in params.items()}
            got = op @ v
            assert max(rel_err(got[n], ref[n]) for n in v) < 1e-12
        else:
            hf = _conv1d_layout(_seq_mlp(device)[0])
            hf_params = dict(hf.named_parameters())
            op = KFACLinearOperator(hf, MSELoss("mean"), hf_params, data, fisher_type="type-2")
            v = {n: torch.randn(p.shape, generator=torch.Generator().manual_seed(1),
                                dtype=p.dtype).to(device) for n, p in params.items()}
            ref = full @ v
            got = op @ {n: (t.T.contiguous() if n.endswith("weight") else t)
                        for n, t in v.items()}
            got = {n: (t.T if n.endswith("weight") else t) for n, t in got.items()}
            assert max(rel_err(got[n], ref[n]) for n in v) < 1e-12
        out[device if device == "cpu" else "card"] = torch.cat(
            [t.reshape(-1).cpu() for t in got.values()])
    assert rel_err(out["card"], out["cpu"]) < 1e-12


@pytest.mark.cuda
def test_conv1d_flash_gpt_taps_on_card(cuda):
    """The flash GPT with ``Conv1D`` block layers: the collector records each
    ``addmm`` as a dense use on batch-major merged rows, the factor pass
    launches every flash kernel once per layer or more, and the factors
    equal those of the ``nn.Linear`` GPT."""
    ops = {}
    for layout in ("linear", "conv1d"):
        problem = tgpt.shakespeare_nanogpt(batch_size=2, config=_STACKED_GPT, device=cuda,
                                           attention_impl="flash")
        params = problem.kfac_params
        if layout == "conv1d":
            _conv1d_layout(problem.model)
            named = dict(problem.model.named_parameters())
            params = {n: named[n] for n in params}
        for n in tfa.launches:
            tfa.launches[n] = 0
        ops[layout] = KFACLinearOperator(problem.model, problem.loss_fn, params, problem.data,
                                         fisher_type="mc", check_deterministic=False)
        assert min(tfa.launches.values()) >= _STACKED_GPT.n_layer, tfa.launches
    uses = [u for g in ops["conv1d"].groups for u in g.uses]
    assert all(u.name.endswith(":addmm") and u.meta["batch_major"] for u in uses)
    index = {g.key: gi for gi, g in enumerate(ops["linear"].groups)}
    for gi, g in enumerate(ops["conv1d"].groups):
        for mine, theirs in ((ops["conv1d"]._aaT, ops["linear"]._aaT),
                             (ops["conv1d"]._ggT, ops["linear"]._ggT)):
            if gi in mine:
                assert rel_err(mine[gi], theirs[index[g.key]]) < 1e-5, g.name


# ---------------------------------------------------------------------- #
# torch.cond-gated layers, the collector's conv coverage, the fuzz twins
# ---------------------------------------------------------------------- #
class _GatedMLP(torch.nn.Module):
    """A tanh MLP 6 -> 8 -> 3 with a residual layer 8 -> 8 between, run
    through ``torch.cond`` on its input's mean: always taken, never taken,
    or (``"two"``) taken against a second layer of distinct weights
    (``fc1b``)."""

    def __init__(self, mode: str):
        super().__init__()
        self.mode = mode
        self.fc0, self.fc1, self.fc2 = (torch.nn.Linear(6, 8), torch.nn.Linear(8, 8),
                                        torch.nn.Linear(8, 3))
        if mode == "two":
            self.fc1b = torch.nn.Linear(8, 8)

    def forward(self, x):  # noqa: D102
        h = torch.tanh(self.fc0(x))
        other = self.fc1b if self.mode == "two" else torch.zeros_like
        pred = h.mean() > (1e30 if self.mode == "untaken" else -1e30)
        return self.fc2(h + torch.cond(pred, self.fc1, other, (h,)))


def _gated_mlp(mode, device, seed=0):
    gen = torch.Generator().manual_seed(seed)
    model = _GatedMLP(mode)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn(p.shape, generator=gen))
    X, y = torch.randn(4, 5, 6, generator=gen), torch.randn(4, 5, 3, generator=gen)
    return model.double().to(device), [(X.double().to(device), y.double().to(device))]


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["taken", "untaken", "two"])
def test_cond_kfac_card_matches_cpu(cuda, mode):
    """KFAC (type-2, with the determinism probe) of a cond-gated MLP on the
    card against the CPU, float64, to 1e-12; the untaken layer's matvec rows
    are exactly 0.0 on both."""
    from curvlinops_tpu_torch.losses import MSELoss

    untaken = {"taken": (), "untaken": ("fc1.weight", "fc1.bias"),
               "two": ("fc1b.weight", "fc1b.bias")}[mode]
    out = []
    for device in ("cpu", cuda):
        model, data = _gated_mlp(mode, device)
        params = dict(model.named_parameters())
        op = KFACLinearOperator(model, MSELoss("mean"), params, data, fisher_type="type-2")
        gen = torch.Generator().manual_seed(1)
        got = op @ {n: torch.randn(p.shape, generator=gen, dtype=p.dtype).to(device)
                    for n, p in params.items()}
        assert all(got[n].abs().max().item() == 0.0 for n in untaken)
        assert all(bool(t.isfinite().all()) for t in got.values())
        out.append(torch.cat([t.reshape(-1).cpu() for t in got.values()]))
    assert rel_err(out[1], out[0]) < 1e-12


@pytest.mark.cuda
@pytest.mark.parametrize("approx", ["expand", "reduce"])
def test_grouped_dilated_conv_kfac_on_card(cuda, approx):
    """A grouped (2 groups, group-replicated input) and dilated conv, then a
    1x1 conv: KFAC equals the block-diagonal dense GGN on the card and the
    CPU's KFAC, float64 (the kernel's gate declines it: the plain path)."""
    from curvlinops_tpu_torch.losses import MSELoss
    from tests.torch_fuzz_cases import blockdiag_ggn, dense_of

    dense = []
    for device in ("cpu", cuda):
        gen = torch.Generator().manual_seed(3)
        conv = torch.nn.Conv2d(4, 4, 3, groups=2, dilation=2, padding="same")
        head = torch.nn.Conv2d(4, 2, 1)
        with torch.no_grad():
            for p in (*conv.parameters(), *head.parameters()):
                p.copy_(0.4 * torch.randn(p.shape, generator=gen))
        pool = approx == "reduce"
        model = torch.nn.Sequential(conv, head).double().to(device)
        base = torch.randn(2, 2, 7, 7, generator=gen, dtype=torch.float64)
        X = torch.cat([base, base], dim=1).to(device)
        out_fn = (lambda z: z.mean(dim=(2, 3))) if pool else (lambda z: z.permute(0, 2, 3, 1))
        wrapped = torch.nn.Sequential(model, _Lambda(out_fn))
        y = torch.randn(out_fn(model(X)).shape, generator=gen, dtype=torch.float64).to(device)
        params = dict(wrapped.named_parameters())
        kfac = KFACLinearOperator(wrapped, MSELoss("sum"), params, [(X, y)],
                                  fisher_type="type-2", kfac_approx=approx)
        dense.append(dense_of(kfac).cpu())
        expected = blockdiag_ggn(wrapped, MSELoss("sum"), params, [(X, y)], kfac.groups)
        assert rel_err(dense[-1], expected.cpu()) < 1e-10
    assert rel_err(dense[1], dense[0]) < 1e-12


class _Lambda(torch.nn.Module):
    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, x):  # noqa: D102
        return self.fn(x)


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["exact_or_refuse", "scan", "linear_sharing", "conv_sharing"])
def test_fuzz_first_chunk_on_card(cuda, family):
    """The first chunk of each collector fuzz family (JAX's seeds; no JAX) on
    the card in float64: exact against the dense GGN or refused, above
    JAX's non-vacuity floor; the scanned stacks equal their unrolled twins."""
    from tests import torch_fuzz_cases as fc

    if family == "scan":
        for seed in range(10):
            fc.scan_equals_unrolled(seed, cuda, torch.float64)
        return
    build, n, atol = {
        "exact_or_refuse": (fc.build_case, 20, 1e-5),
        "linear_sharing": (fc.build_linear_sharing_case, 20, 1e-5),
        "conv_sharing": (fc.build_conv_sharing_case, 15, 2e-5),
    }[family]
    built, refused = fc.run_chunk(build, range(n), atol, cuda, torch.float64)
    assert built >= n // 3, (built, refused)


# ---------------------------------------------------------------------- #
# data parallelism and the prefetching pipeline on the card
# ---------------------------------------------------------------------- #
@pytest.mark.cuda
def test_prefetch_lands_on_the_card(cuda):
    """32 host batches of 8 MiB through ``PrefetchToDevice(size=2)``: each
    arrives on ``cuda:0`` equal to its source, read on the consumer's stream."""
    from curvlinops_tpu_torch import PrefetchToDevice

    gen = torch.Generator().manual_seed(0)
    sources = [torch.randn(2 * 1024 * 1024, generator=gen) for _ in range(32)]
    got = 0
    for (x,), src in zip(PrefetchToDevice([(s,) for s in sources], size=2, device=cuda), sources):
        assert x.device == cuda and torch.equal((x * 2.0).cpu(), src * 2.0)
        got += 1
    assert got == 32


@pytest.mark.cuda
def test_one_process_nccl_mesh_matches_meshless(cuda):
    """``make_mesh()`` in one process: an NCCL group of one; the narrow
    ResNet's float64 GGN matvec with the mesh equals the one without."""
    import torch.distributed as dist

    from curvlinops_tpu_torch.parallel import make_mesh

    ours = not dist.is_initialized()
    try:
        mesh = make_mesh()
        assert "nccl" in str(dist.get_backend())
        p = tresnet.narrow_resnet_problem(device=cuda)
        gen = torch.Generator().manual_seed(0)
        v = {n: torch.randn(t.shape, generator=gen, dtype=t.dtype).to(cuda)
             for n, t in p.params.items()}
        out = [GGNLinearOperator(p.model, p.loss_fn, p.params, p.data, mesh=m) @ v
               for m in (None, mesh)]
        flat = [torch.cat([t.reshape(-1) for t in o.values()]) for o in out]
        assert rel_err(flat[1], flat[0]) < 1e-12
    finally:
        if ours and dist.is_initialized():
            dist.destroy_process_group()


@pytest.mark.cuda
def test_two_process_nccl_mesh_matches_meshless(cuda, tmp_path):
    """Two processes, one card each (``tests/torch_parallel_worker.py``'s
    NCCL world): the narrow ResNet's GGN matvec split over the mesh equals
    the mesh-less one."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    root = Path(__file__).resolve().parents[1]
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([str(root), os.environ.get("PYTHONPATH", "")])}
    procs = [subprocess.Popen([sys.executable, "-m", "tests.torch_parallel_worker", str(tmp_path),
                               str(r), "2", "nccl"], cwd=root, env=env) for r in range(2)]
    try:
        codes = [p.wait(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert codes == [0, 0]
    res = torch.load(tmp_path / "results.pt", weights_only=False)
    assert "nccl" in res["backend"] and res["rel_err"] < 1e-12


# ---------------------------------------------------------------------- #
# captured programs: the fused loop, Neumann and Lanczos as CUDA graphs
# ---------------------------------------------------------------------- #
FUSED_SPLITS = {"single": [6], "scan": [2, 2, 2], "unroll": [2, 3, 1]}


def _fused_pair(cuda, op: str, mode: str, prefetch: bool = False):
    """The narrow ResNet (float64) on 6 images split as ``mode``: the
    operator fused, and the same operator streamed (from host batches
    through ``PrefetchToDevice`` with ``prefetch``)."""
    p = tresnet.narrow_resnet_problem(device=cuda)
    gen = torch.Generator().manual_seed(1)
    X = torch.rand((6, 3, 16, 16), generator=gen, dtype=torch.float64).to(cuda)
    y = torch.randint(0, 10, (6,), generator=gen).to(cuda)
    data = list(zip(X.split(FUSED_SPLITS[mode]), y.split(FUSED_SPLITS[mode])))
    cls, kw = {"ggn": (GGNLinearOperator, {}), "mc": (GGNLinearOperator, {"mc_samples": 1}),
               "hessian": (HessianLinearOperator, {}), "ef": (EFLinearOperator, {}),
               "gradient": (GGNLinearOperator, {})}[op]
    fed = PrefetchToDevice([(X.cpu(), y.cpu()) for X, y in data], device=cuda) if prefetch else data
    fused, streamed = (cls(p.model, p.loss_fn, p.params, d, check_deterministic=False, **kw)
                       for d in (data, fed))
    streamed.fuse_batches = False
    v = {n: torch.randn(t.shape, generator=gen, dtype=t.dtype).to(cuda)
         for n, t in p.params.items()}
    return fused, streamed, v


def _flat(tree) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for t in tree.values()])


@pytest.mark.cuda
@pytest.mark.parametrize("mode", list(FUSED_SPLITS))
@pytest.mark.parametrize("op", ["ggn", "mc", "hessian", "ef", "gradient"])
def test_fused_matches_streamed_on_card(cuda, op, mode):
    """Each operator's captured program (and the captured gradient) against
    the streamed loop, float64; the mode record and the graph exist."""
    fused, streamed, v = _fused_pair(cuda, op, mode)
    if op == "gradient":
        (g1, l1), (g2, l2) = fused.gradient_and_loss(), streamed.gradient_and_loss()
        out, ref = torch.cat([_flat(g1), l1[None]]), torch.cat([_flat(g2), l2[None]])
        key = ("fused_grad_loss",)
    else:
        out, ref = _flat(fused @ v), _flat(streamed @ v)
        key = ("fused_matmat", 1, torch.float64)
    assert fused._batch_fn_cache["fused_state"][0] == mode
    assert fused._program_cache[1][key]._graph is not None
    assert rel_err(out, ref) < 1e-10


@pytest.mark.cuda
def test_fused_mc_replays_equal_and_outputs_not_aliased_on_card(cuda):
    """Two replays of the MC Fisher's program draw the same samples (its
    taped draws), the streamed loop's; a result kept across a later call is
    unchanged."""
    fused, streamed, v = _fused_pair(cuda, "mc", "unroll")
    first = fused @ v
    kept = _flat(first).clone()
    second = fused @ {n: 2 * t for n, t in v.items()}
    assert torch.equal(_flat(first), kept)
    assert rel_err(_flat(second), 2 * kept) < 1e-12
    assert rel_err(kept, _flat(streamed @ v)) < 1e-10


@pytest.mark.cuda
def test_neumann_captures_fused_ggn_inline_on_card(cuda):
    """A Neumann series over the fused ``G + I`` is one graph that runs the
    GGN's loop inline (the GGN captures no graph of its own); it equals the
    series over the streamed GGN, which runs eagerly and keeps no program.
    Fast Lanczos likewise, through its public entry."""
    from curvlinops_tpu_torch import IdentityLinearOperator, NeumannInverseLinearOperator
    from curvlinops_tpu_torch.solvers import lanczos as tlanczos

    fused, streamed, v = _fused_pair(cuda, "ggn", "scan")
    ops = {}
    for name, G in (("fused", fused), ("streamed", streamed)):
        ops[name] = NeumannInverseLinearOperator(G + IdentityLinearOperator(G.in_spec),
                                                 num_terms=8, scale=0.5)
    x = ops["fused"] @ v
    program = ops["fused"]._program_cache[1][("neumann", 1, torch.float64)]
    assert program._graph is not None
    assert fused._program_cache[1][("fused_matmat", 1, torch.float64)]._graph is None
    assert rel_err(_flat(x), _flat(ops["streamed"] @ v)) < 1e-10
    assert "_program_cache" not in ops["streamed"].__dict__
    v0 = torch.randn(fused.shape[1], generator=torch.Generator().manual_seed(2),
                     dtype=torch.float64).to(cuda)
    evals, ref = (tlanczos.fast_lanczos(G, 6, v0=v0)[0] for G in (fused, streamed))
    assert fused._program_cache[1][("fast_lanczos", 6, 1, torch.float64)]._graph is not None
    assert rel_err(evals, ref) < 1e-10


@pytest.mark.cuda
@pytest.mark.parametrize("prefetch", [False, True], ids=["resident", "prefetch"])
def test_series_over_streamed_mc_ggn_on_card(cuda, prefetch):
    """A Neumann series over ``fuse_batches = False``'s MC GGN plus the
    identity (resident batches, or host batches through
    ``PrefetchToDevice``), and fast Lanczos on it, run eagerly through the
    public entries (fresh generators a product, a loader thread: nothing a
    graph may hold) and equal the captured programs over the fused MC
    GGN."""
    from curvlinops_tpu_torch import IdentityLinearOperator, NeumannInverseLinearOperator
    from curvlinops_tpu_torch.solvers import lanczos as tlanczos

    fused, streamed, v = _fused_pair(cuda, "mc", "unroll", prefetch=prefetch)
    assert fused.capturable and not streamed.capturable
    inv = {name: NeumannInverseLinearOperator(G + IdentityLinearOperator(G.in_spec),
                                              num_terms=8, scale=0.5)
           for name, G in (("fused", fused), ("streamed", streamed))}
    assert rel_err(_flat(inv["streamed"] @ v), _flat(inv["fused"] @ v)) < 1e-10
    assert "_program_cache" not in inv["streamed"].__dict__
    assert inv["fused"]._program_cache[1][("neumann", 1, torch.float64)]._graph is not None
    v0 = torch.randn(fused.shape[1], generator=torch.Generator().manual_seed(4),
                     dtype=torch.float64).to(cuda)
    ritz, ref = (tlanczos.fast_lanczos(G, 6, v0=v0)[0] for G in (streamed, fused))
    assert rel_err(ritz, ref) < 1e-10 and "_program_cache" not in streamed.__dict__


@pytest.mark.cuda
def test_epoch_bump_frees_the_pool_on_card(cuda):
    """Dropping an operator's programs (``invalidate_traced``) frees their
    graphs' pool: the reserved memory falls."""
    import gc

    fused, _, v = _fused_pair(cuda, "hessian", "scan")
    fused @ v
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_reserved(cuda)
    program = fused._program_cache[1][("fused_matmat", 1, torch.float64)]
    grown = program.reserved_bytes[1] - program.reserved_bytes[0]
    assert grown > 0
    del program
    fused.invalidate_traced()
    gc.collect()
    torch.cuda.empty_cache()
    assert torch.cuda.memory_reserved(cuda) <= held - grown


@pytest.mark.cuda
def test_capture_failure_raises_on_card(cuda):
    """A model that reads the host cannot be captured: the product raises
    with the reason instead of streaming; ``fuse_batches = False`` streams."""

    class HostRead(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.lin = torch.nn.Linear(4, 3)

        def forward(self, x):
            if x.abs().sum().item() < 0:  # a host read: refused under capture
                x = -x
            return self.lin(x)

    model = HostRead().to(cuda)
    gen = torch.Generator().manual_seed(0)
    data = [(torch.randn(8, 4, generator=gen).to(cuda), torch.randint(0, 3, (8,)).to(cuda))]
    G = GGNLinearOperator(model, CrossEntropyLoss("mean"), dict(model.named_parameters()), data,
                          check_deterministic=False)
    v = torch.randn(G.shape[1], generator=gen).to(cuda)
    with pytest.raises(RuntimeError, match="(?s)CUDA graph failed.*fuse_batches"):
        G @ v
    G.fuse_batches = False
    assert torch.isfinite(G @ v).all()


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["taken", "untaken", "two"])
def test_cond_model_fused_on_card(cuda, mode):
    """A ``torch.cond``-gated MLP's GGN is captured (its predicate cannot be
    read while the stream is captured, so both branches run under
    ``torch.where``) and equals the streamed GGN, float64."""
    from curvlinops_tpu_torch.losses import MSELoss

    model, data = _gated_mlp(mode, cuda)
    params = dict(model.named_parameters())
    fused, streamed = (GGNLinearOperator(model, MSELoss("mean"), params, data,
                                         check_deterministic=False) for _ in range(2))
    streamed.fuse_batches = False
    gen = torch.Generator().manual_seed(1)
    v = {n: torch.randn(p.shape, generator=gen, dtype=p.dtype).to(cuda) for n, p in params.items()}
    assert rel_err(_flat(fused @ v), _flat(streamed @ v)) < 1e-12
    assert fused._program_cache[1][("fused_matmat", 1, torch.float64)]._graph is not None


# ---------------------------------------------------------------------- #
# captured solvers: the chunked loop, the small-eigh kernel, and the
# operators marked capturable
# ---------------------------------------------------------------------- #
def _count_step(k, state, consts):
    """A loop step that doubles and shifts ``x``, records it, and goes on
    while ``k + 1 < stop``."""
    x, hist = state
    (stop,) = consts
    x = 2 * x + 1
    index = torch.clamp(k + 1, max=hist.shape[0] - 1).reshape(1)
    return (x, hist.index_copy(0, index, x[None])), k + 1 < stop


@pytest.mark.cuda
def test_chunked_loop_masks_steps_past_the_stop_on_card(cuda):
    """The masked chunk (the card's torch has no conditional graph nodes):
    stops at 1, ``CHUNK - 1``, ``CHUNK``, ``CHUNK + 1`` and past ``maxiter``
    commit exactly the steps before the stop, equal the eager loop's state,
    read the host once a replay, and reuse one captured graph."""
    import math

    from curvlinops_tpu_torch.utils.graphs import CHUNK, ChunkedLoop, EagerLoop

    maxiter = 2 * CHUNK + 1
    loop = ChunkedLoop(cuda, "the counting loop")
    graphs = set()
    for stop in (1, CHUNK - 1, CHUNK, CHUNK + 1, 3 * CHUNK):
        state = (torch.zeros(3, dtype=torch.float64, device=cuda),
                 torch.zeros((maxiter + 1, 3), dtype=torch.float64, device=cuda))
        consts = (torch.tensor(stop, device=cuda),)
        running = torch.ones((), dtype=torch.bool, device=cuda)
        (x, hist), k, reads = loop(_count_step, maxiter, state, consts, running)
        (x_e, hist_e), k_e, _ = EagerLoop()(_count_step, maxiter, state, consts, running)
        graphs.add(id(loop._graph))
        assert k == k_e == min(stop, maxiter) and reads == math.ceil(k / CHUNK)
        assert torch.equal(x, x_e) and torch.equal(hist, hist_e)
        assert float(x[0]) == 2.0**k - 1 and float(hist[k, 0]) == 2.0**k - 1
    assert len(graphs) == 1 and loop.capture_seconds is not None


def _solver_case(cuda):
    """The tiny MLP's module on one batch (float64): a fused and a streamed
    GGN + 0.1 I, the fused and streamed Jacobians, and KFAC's damped
    inverse (type-2)."""
    from curvlinops_tpu_torch import IdentityLinearOperator

    model, params, data = _kfac_case(tmlp.tiny_mlp_problem, cuda)
    loss = CrossEntropyLoss("mean")
    ops = {}
    for mode in ("fused", "streamed"):
        G = GGNLinearOperator(model, loss, params, data, check_deterministic=False)
        J = JacobianLinearOperator(model, params, data, check_deterministic=False)
        if mode == "streamed":
            G.fuse_batches = J.fuse_batches = False
        ops[mode] = (G + 0.1 * IdentityLinearOperator(G.in_spec), J)
    kfac = KFACLinearOperator(model, loss, params, data, fisher_type="type-2",
                              check_deterministic=False)
    return ops, kfac.inverse(damping=0.1)


@pytest.mark.cuda
@pytest.mark.parametrize("solver", ["cg", "pcg", "minres", "lsmr", "lobpcg"])
def test_captured_solver_matches_eager_on_card(cuda, solver):
    """Each solve over the fused operators runs as a captured chunked loop
    and equals the same solve over the streamed ones, which runs eagerly
    (float64, 1e-10): at a fixed iteration count and at a tolerance that
    stops it mid-run, with the same iteration count and at most
    ``ceil(iterations / CHUNK) + 1`` host reads."""
    import math

    from curvlinops_tpu_torch import (
        CGInverseLinearOperator,
        LSMRInverseLinearOperator,
        MINRESInverseLinearOperator,
    )
    from curvlinops_tpu_torch.solvers.eigsh import topk_eigenpairs
    from curvlinops_tpu_torch.utils.graphs import CHUNK

    ops, kinv = _solver_case(cuda)
    gen = torch.Generator().manual_seed(3)
    n = ops["fused"][0].shape[0]
    if solver == "lobpcg":
        X0 = torch.randn((n, 2), generator=gen, dtype=torch.float64).to(cuda)
        G = ops["fused"][0]
        out = {m: topk_eigenpairs(ops[m][0], 2, maxiter=9, X0=X0, tol=1e-12)
               for m in ("fused", "streamed")}
        (loop,) = [p for p in G._program_cache[1].values() if hasattr(p, "host_reads")]
        assert loop._graph is not None and loop.host_reads == math.ceil(9 / CHUNK)
        assert rel_err(out["fused"][0], out["streamed"][0]) < 1e-10
        proj = [U @ U.T for _, U in out.values()]
        assert rel_err(proj[0], proj[1]) < 1e-8
        return
    for stop in ({"tol": 0.0, "atol": 0.0}, {"tol": 1e-6, "atol": 0.0}):
        infos, xs = {}, {}
        for mode in ("fused", "streamed"):
            A, J = ops[mode]
            if solver == "lsmr":
                inv = LSMRInverseLinearOperator(J, maxiter=40, atol=stop["tol"], btol=stop["tol"])
                B = torch.randn((J.shape[0], 2), generator=torch.Generator().manual_seed(4),
                                dtype=torch.float64).to(cuda)
            else:
                cls = MINRESInverseLinearOperator if solver == "minres" else CGInverseLinearOperator
                kw = {"preconditioner": kinv} if solver == "pcg" else {}
                inv = cls(A, maxiter=40 if stop["tol"] else 11, **stop, **kw)
                B = torch.randn((n, 2), generator=torch.Generator().manual_seed(4),
                                dtype=torch.float64).to(cuda)
            xs[mode] = inv @ B
            infos[mode] = inv.lsmr_info if solver == "lsmr" else inv.last_info
            if mode == "fused":
                assert any(getattr(p, "_graph", None) is not None
                           for p in inv._program_cache[1].values())
            else:
                assert "_program_cache" not in inv.__dict__
        k = infos["fused"]["iterations"]
        assert k == infos["streamed"]["iterations"] and k > 0
        assert infos["fused"]["host_reads"] <= math.ceil(k / CHUNK) + 1
        assert infos["streamed"]["host_reads"] >= k
        assert rel_err(xs["fused"], xs["streamed"]) < 1e-10


def _symmetric(n: int, dtype, repeated: bool, gen) -> torch.Tensor:
    """A random symmetric ``[n, n]``, or one whose eigenvalues repeat in
    threes (``Q diag(w) Q^T``)."""
    A = torch.randn((n, n), generator=gen, dtype=torch.float64)
    if repeated:
        Q = torch.linalg.qr(A)[0]
        w = torch.arange(n, dtype=torch.float64).div(3).floor() - n / 6
        A = (Q * w) @ Q.T
    return ((A + A.T) / 2).to(dtype)


def _cluster_projector_error(w, V, w_ref, V_ref, gap: float) -> float:
    """The largest distance between the two spectral projectors of a
    cluster of eigenvalues (consecutive ones closer than ``gap``)."""
    worst, start = 0.0, 0
    for i in range(1, len(w_ref) + 1):
        if i == len(w_ref) or w_ref[i - 1] - w_ref[i] > gap:
            P = V[:, start:i] @ V[:, start:i].T
            P_ref = V_ref[:, start:i] @ V_ref[:, start:i].T
            worst, start = max(worst, float((P - P_ref).norm())), i
    return worst


@pytest.mark.cuda
@pytest.mark.parametrize("repeated", [False, True], ids=["distinct", "repeated"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("n", [3, 12, 16, 17, 33, 38, 39, 44, 45, 48, 96, 121])
def test_small_eigh_kernel_matches_eigh_on_card(cuda, n, dtype, repeated):
    """The Jacobi kernel on a batch of three matrices against
    ``torch.linalg.eigh`` (descending), by the shared route to n = 16 and at
    33-38 and the cluster route for the others (one launch, counted at its
    size; 33, 39, 45 and 121 are not multiples of the cluster route's
    32-index pairs): eigenvalues
    within ``20 n eps`` of the largest, residuals ``||A V - V diag(w)||``
    and ``||V^T V - I||`` within ``20 n eps`` (times ``||A||``), and each
    cluster's projector (eigenvalues closer than ``10^-2 ||A||``) within
    ``20 n eps ||A||`` over the gap. Refuses n = 513 and integer matrices."""
    from curvlinops_tpu_torch.solvers import small_eigh as se

    gen = torch.Generator().manual_seed(n)
    A = torch.stack([_symmetric(n, dtype, repeated, gen) for _ in range(3)]).to(cuda)
    before, sizes = se.small_eigh.launches, dict(se.small_eigh.size_launches)
    w, V = se.small_eigh(A)
    torch.cuda.synchronize()
    assert se.small_eigh.launches == before + 1
    sizes[n] = sizes.get(n, 0) + 1
    assert se.small_eigh.size_launches == sizes
    w_ref, V_ref = se.small_eigh_plain(A)
    tol = 20 * n * torch.finfo(dtype).eps
    for b in range(3):
        Ab, scale = A[b].double(), float(A[b].double().norm())
        wb, Vb = w[b].double(), V[b].double()
        assert float((wb - w_ref[b].double()).abs().max()) <= tol * scale
        assert bool((wb[:-1] >= wb[1:]).all())
        assert float((Ab @ Vb - Vb * wb).norm()) <= tol * scale
        assert float((Vb.T @ Vb - torch.eye(n, dtype=torch.float64, device=cuda)).norm()) <= tol
        gap = 1e-2 * scale
        err = _cluster_projector_error(wb, Vb, w_ref[b].double(), V_ref[b].double(), gap)
        assert err <= tol * scale / gap
    with pytest.raises(ValueError, match="square matrices"):
        se.small_eigh(torch.eye(513, device=cuda))
    with pytest.raises(TypeError, match="float32 or float64"):
        se.small_eigh(torch.eye(3, dtype=torch.int32, device=cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("n", [97, 128, 160, 161, 300, 511, 512])
def test_small_eigh_kernel_large_n_on_card(cuda, monkeypatch, n, dtype):
    """The kernel past its old limit of 96, by its cluster route (a cluster
    of ``ceil(n / 32)`` CTAs, A and V^T in a device-memory workspace; 161,
    300 and 511 pad to a multiple of 32), on a batch of two matrices against
    ``torch.linalg.eigh``:
    eigenvalues within ``20 n eps`` of ``||A||``, ``||A V - V diag(w)||``
    within ``20 n eps ||A||``, and ``||V^T V - I||`` in the spectral norm
    within ``20 n eps`` (Jacobi's rounding grows about as ``n^1.5 eps`` in
    the Frobenius norm, which the spectral norm divides by about
    ``sqrt(n)``). The launch never reaches ``torch.linalg.eigh``."""
    from curvlinops_tpu_torch.solvers import small_eigh as se

    gen = torch.Generator().manual_seed(n)
    A = torch.stack([_symmetric(n, dtype, repeated, gen) for repeated in (False, True)]).to(cuda)
    w_ref, V_ref = se.small_eigh_plain(A)

    def refuse(_):
        raise AssertionError("small_eigh reached torch.linalg.eigh on the card")

    monkeypatch.setattr(se, "small_eigh_plain", refuse)
    monkeypatch.setattr(torch.linalg, "eigh", refuse)
    before = se.small_eigh.launches
    sweeps = torch.zeros(2, dtype=torch.int32, device=cuda)
    w, V = se.small_eigh(A, sweeps)
    torch.cuda.synchronize()
    monkeypatch.undo()
    assert se.small_eigh.launches == before + 1 and w.dtype == V.dtype == dtype
    assert 0 < int(sweeps.min()) and int(sweeps.max()) < se.MAX_SWEEPS
    tol = 20 * n * torch.finfo(dtype).eps
    eye = torch.eye(n, dtype=torch.float64, device=cuda)
    for b in range(2):
        Ab, scale = A[b].double(), float(A[b].double().norm())
        wb, Vb = w[b].double(), V[b].double()
        assert float((wb - w_ref[b].double()).abs().max()) <= tol * scale
        assert bool((wb[:-1] >= wb[1:]).all())
        assert float((Ab @ Vb - Vb * wb).norm()) <= tol * scale
        assert float(torch.linalg.matrix_norm(Vb.T @ Vb - eye, ord=2)) <= tol


def _check_eigh(A, w, V, tol: float, gap_rel: float = 1e-2) -> None:
    """One matrix's eigenpairs against float64 ``eigh``: eigenvalues within
    ``tol ||A||``, descending, ``||A V - V diag(w)||`` within ``tol ||A||``,
    ``||V^T V - I||`` (spectral) within ``tol``, and each cluster's projector
    (eigenvalues closer than ``gap_rel ||A||``) within ``tol ||A||`` over the
    gap."""
    n = A.shape[-1]
    A64, w, V = A.double(), w.double(), V.double()
    scale = float(A64.norm())
    w_ref, V_ref = (t.flip(-1) for t in torch.linalg.eigh(A64))
    assert float((w - w_ref).abs().max()) <= tol * scale
    assert bool((w[:-1] >= w[1:]).all())
    assert float((A64 @ V - V * w).norm()) <= tol * scale
    eye = torch.eye(n, dtype=torch.float64, device=A.device)
    assert float(torch.linalg.matrix_norm(V.T @ V - eye, ord=2)) <= tol
    gap = gap_rel * scale
    assert _cluster_projector_error(w, V, w_ref, V_ref, gap) <= tol * scale / gap


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("shape", [(3, 4), (10, 12), (15, 20)], ids=["12", "120", "300"])
def test_small_eigh_kernel_kronecker_spectrum_on_card(cuda, shape, dtype):
    """A KFAC-like spectrum: ``kron(B, C)`` of two SPD factors, ``C`` with
    each eigenvalue twice, turned by a random orthogonal similarity so that
    no entry is zero: every eigenvalue of the product repeats. The kernel
    (shared route at 12, cluster route at 120 and 300) within the card
    tests' ``20 n eps`` and its clusters' projectors against ``eigh``."""
    from curvlinops_tpu_torch.solvers import small_eigh as se

    b, c = shape
    n = b * c
    gen = torch.Generator().manual_seed(n)
    X = torch.randn((b, b), generator=gen, dtype=torch.float64)
    B = X @ X.T / b + torch.eye(b, dtype=torch.float64)
    Qc = torch.linalg.qr(torch.randn((c, c), generator=gen, dtype=torch.float64))[0]
    C = (Qc * torch.arange(c, dtype=torch.float64).div(2).floor().add(1)) @ Qc.T
    Q = torch.linalg.qr(torch.randn((n, n), generator=gen, dtype=torch.float64))[0]
    A = (Q @ torch.kron(B, C) @ Q.T).to(dtype).to(cuda)
    A = (A + A.T) / 2
    sweeps = torch.zeros(1, dtype=torch.int32, device=cuda)
    w, V = se.small_eigh(A[None], sweeps)
    torch.cuda.synchronize()
    assert 0 < int(sweeps[0]) < se.MAX_SWEEPS
    _check_eigh(A, w[0], V[0], 20 * n * torch.finfo(dtype).eps)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [12, 120], ids=["shared", "cluster"])
def test_small_eigh_kernel_special_inputs_on_card(cuda, n):
    """Inputs that stop before a sweep: a diagonal matrix (eigenvalues its
    sorted diagonal, eigenvectors the matching unit vectors), the zero
    matrix (zeros and the identity) and a matrix with a NaN off its
    diagonal or on it (it stops at once: no hang, the diagonal returned,
    a NaN ranked first), each at sweep 0, on both routes."""
    from curvlinops_tpu_torch.solvers import small_eigh as se

    gen = torch.Generator().manual_seed(n)
    d = torch.randn(n, generator=gen)
    dense = torch.randn((n, n), generator=gen)
    off_nan, diag_nan = (dense + dense.T) / 2, (dense + dense.T) / 2
    off_nan[5, 2] = off_nan[2, 5] = float("nan")
    diag_nan[3, 3] = float("nan")
    cases = {"diagonal": torch.diag(d), "zero": torch.zeros((n, n)), "nan off": off_nan,
             "nan on": diag_nan}
    sweeps = torch.full((len(cases),), -1, dtype=torch.int32, device=cuda)
    w, V = se.small_eigh(torch.stack(list(cases.values())).to(cuda), sweeps)
    torch.cuda.synchronize()
    assert sweeps.tolist() == [0] * len(cases)
    order = torch.argsort(d, descending=True)
    assert torch.equal(w[0].cpu(), d[order])
    assert torch.equal(V[0].cpu(), torch.eye(n)[:, order])
    assert torch.equal(w[1].cpu(), torch.zeros(n)) and torch.equal(V[1].cpu(), torch.eye(n))
    diag = torch.diagonal(off_nan)
    assert torch.equal(w[2].cpu(), diag[torch.argsort(diag, descending=True)])
    assert bool(torch.isnan(w[3, 0])) and bool(torch.isfinite(w[3, 1:]).all())
    assert bool((w[3, 1:-1] >= w[3, 2:]).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_small_eigh_kernel_captured_on_card(cuda, dtype):
    """The cluster route at n = 120 captured in a CUDA graph (one cluster
    launch, the workspace from the graph's pool) and replayed: the replay
    equals an eager call to the bit, and its launches were counted at the
    capture, not at the replay."""
    from curvlinops_tpu_torch.solvers import small_eigh as se

    gen = torch.Generator().manual_seed(120)
    A = _symmetric(120, dtype, False, gen).to(cuda)
    w_e, V_e = se.small_eigh(A)
    torch.cuda.synchronize()
    static = A.clone()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):  # warm-up off the capturing stream
        se.small_eigh(static)
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    before = se.small_eigh.size_launches[120]
    with torch.cuda.graph(graph):
        w_g, V_g = se.small_eigh(static)
    assert se.small_eigh.size_launches[120] == before + 1
    static.copy_(A)
    graph.replay()
    graph.replay()
    torch.cuda.synchronize()
    assert se.small_eigh.size_launches[120] == before + 1
    assert torch.equal(w_g, w_e) and torch.equal(V_g, V_e)


@pytest.mark.cuda
def test_small_eigh_kernel_refused_launch_raises_on_card(cuda, monkeypatch):
    """A cluster launch the kernel refuses (a batch past the grid's 65,535
    clusters) raises in the wrapper and never reaches
    ``torch.linalg.eigh``."""
    from curvlinops_tpu_torch.solvers import small_eigh as se

    def refuse(_):
        raise AssertionError("small_eigh reached torch.linalg.eigh on the card")

    monkeypatch.setattr(se, "small_eigh_plain", refuse)
    monkeypatch.setattr(torch.linalg, "eigh", refuse)
    before = se.small_eigh.launches
    A = torch.zeros((65536, 17, 17), device=cuda)
    with pytest.raises(RuntimeError, match="launch failed"):
        se.small_eigh(A)
    assert se.small_eigh.launches == before


def _known_spectrum(dim: int, k: int, gen):
    """A dense float64 ``[dim, dim]`` symmetric matrix whose top ``k``
    eigenvalues are ``linspace(2, 1, k)`` and the rest ``k / dim`` apart in
    ``[0, 0.5]``: a gap LOBPCG closes in tens of iterations."""
    Q = torch.linalg.qr(torch.randn((dim, dim), generator=gen, dtype=torch.float64))[0]
    lam = torch.cat([torch.linspace(2.0, 1.0, k, dtype=torch.float64),
                     torch.linspace(0.5, 0.0, dim - k, dtype=torch.float64)])
    return (Q * lam) @ Q.T, lam


@pytest.mark.cuda
@pytest.mark.parametrize("capture", ["auto", True, False], ids=["auto", "true", "eager"])
@pytest.mark.parametrize("k", [33, 40])
def test_lobpcg_large_k_on_card(cuda, k, capture):
    """LOBPCG past the kernel's old limit (``[99, 99]`` and ``[120, 120]``
    Rayleigh-Ritz problems) on a dense capturable operator of known spectrum
    (float64, dimension 256): the top ``k`` within 1e-8 of the exact
    eigenvalues, orthonormal to 1e-8, through the small-eigh kernel (its
    launches counted, ``torch.linalg.eigh`` never called); ``"auto"`` and
    ``True`` cache a chunked loop, and equal the eager run to 1e-10."""
    from curvlinops_tpu_torch import MatrixLinearOperator
    from curvlinops_tpu_torch.solvers import small_eigh as se
    from curvlinops_tpu_torch.solvers.eigsh import topk_eigenpairs
    from curvlinops_tpu_torch.utils.graphs import ChunkedLoop

    gen = torch.Generator().manual_seed(k)
    M, lam = _known_spectrum(256, k, gen)
    X0 = torch.randn((256, k), generator=gen, dtype=torch.float64).to(cuda)
    A = MatrixLinearOperator(M.to(cuda))
    eigh = torch.linalg.eigh
    calls = []
    try:
        torch.linalg.eigh = lambda *a, **kw: (calls.append(1), eigh(*a, **kw))[1]
        before = se.small_eigh.launches
        w, V = topk_eigenpairs(A, k, maxiter=100, X0=X0, capture=capture)
        torch.cuda.synchronize()
        launches = se.small_eigh.launches - before
    finally:
        torch.linalg.eigh = eigh
    assert not calls and launches > 0
    assert float((w.cpu() - lam[:k]).abs().max()) <= 1e-8
    assert float((V.T @ V - torch.eye(k, dtype=torch.float64, device=cuda)).abs().max()) <= 1e-8
    cached = "_program_cache" in A.__dict__ and any(
        isinstance(p, ChunkedLoop) for p in A._program_cache[1].values())
    assert cached == (capture is not False)
    if capture is not False:
        w_e, _ = topk_eigenpairs(A, k, maxiter=100, X0=X0, capture=False)
        assert rel_err(w, w_e) <= 1e-10


@pytest.mark.cuda
def test_lobpcg_past_the_kernel_limit_on_card(cuda):
    """``k = 171`` (a ``[513, 513]`` Rayleigh-Ritz problem, past the
    kernel's 512): ``capture=True`` raises naming the limit and the way out,
    ``"auto"`` runs eagerly through ``torch.linalg.eigh`` (no program
    cached, no kernel launch), three iterations, finite and descending."""
    from curvlinops_tpu_torch import MatrixLinearOperator
    from curvlinops_tpu_torch.solvers import small_eigh as se
    from curvlinops_tpu_torch.solvers.eigsh import topk_eigenpairs

    from curvlinops_tpu_torch.utils.graphs import ChunkedLoop

    k, dim = 171, 5 * 171 + 4
    gen = torch.Generator().manual_seed(k)
    M, _ = _known_spectrum(dim, k, gen)
    A = MatrixLinearOperator(M.to(cuda))
    X0 = torch.randn((dim, k), generator=gen, dtype=torch.float64).to(cuda)
    with pytest.raises(ValueError, match=r"(?s)\[513, 513\].*512.*capture=False"):
        topk_eigenpairs(A, k, maxiter=3, X0=X0, capture=True)
    before = se.small_eigh.launches
    w, V = topk_eigenpairs(A, k, maxiter=3, X0=X0)
    torch.cuda.synchronize()
    assert se.small_eigh.launches == before
    assert "_program_cache" not in A.__dict__ or not any(
        isinstance(p, ChunkedLoop) for p in A._program_cache[1].values())
    assert w.shape == (k,) and bool(torch.isfinite(w).all()) and bool((w[:-1] >= w[1:]).all())


def _uncaptured(A):
    """``A``'s products behind an operator that no program captures
    (``capturable`` False): a series over it runs eagerly."""
    from curvlinops_tpu_torch.ops.base import LinearOperator

    class Wrapped(LinearOperator):
        def _matmat(self, M):
            return A._matmat(M)

    op = Wrapped(A.in_spec, A.out_spec)
    op.SELF_ADJOINT = A.SELF_ADJOINT
    return op


def _capturable_operator(kind: str, cuda):
    """One operator of each class marked ``capturable`` (float64)."""
    from curvlinops_tpu_torch import (
        BlockDiagonalLinearOperator,
        EKFACLinearOperator,
        EighDecomposedLinearOperator,
        KroneckerProductLinearOperator,
        KFOCLinearOperator,
        MatrixLinearOperator,
        SubmatrixLinearOperator,
    )
    from curvlinops_tpu_torch.ops.kronecker import EmbeddingEighOperator, EmbeddingKroneckerOperator
    from curvlinops_tpu_torch.ops.stacked import StackedEighOperator, StackedKroneckerOperator

    gen = torch.Generator().manual_seed(5)
    kw = dict(dtype=torch.float64)

    def spd(*shape):
        M = torch.randn(*shape, generator=gen, **kw)
        return (M @ M.mT / shape[-1] + torch.eye(shape[-1], **kw)).to(cuda)

    def orth(*shape):
        return torch.linalg.qr(torch.randn(*shape, generator=gen, **kw))[0].to(cuda)

    if kind in ("kfac", "kfac_exact", "kfac_rank", "ekfac", "kfoc"):
        model, params, data = _kfac_case(tmlp.tiny_mlp_problem, cuda)
        args = (model, CrossEntropyLoss("mean"), params, data)
        kw2 = dict(fisher_type="type-2", check_deterministic=False)
        cls = {"ekfac": EKFACLinearOperator, "kfoc": KFOCLinearOperator}.get(kind, KFACLinearOperator)
        A = cls(*args, **kw2)
        if kind == "kfac_exact":
            A = A.inverse(damping=0.1, use_exact_damping=True)
        elif kind == "kfac_rank":
            A = A.inverse(damping=0.1, use_exact_damping=True, rank=4)
        return A
    if kind == "kron":
        return KroneckerProductLinearOperator(spd(3, 3), spd(4, 4))
    if kind == "stacked_kron":
        return StackedKroneckerOperator(spd(2, 3, 3), spd(2, 4, 4))
    if kind == "stacked_eigh":
        lam = torch.rand((2, 12), generator=gen, **kw).to(cuda) + 0.5
        return StackedEighOperator(lam, [orth(2, 3, 3), orth(2, 4, 4)])
    if kind == "embedding_kron":
        return EmbeddingKroneckerOperator(spd(3, 3), (torch.rand(5, generator=gen, **kw) + 0.5).to(cuda))
    if kind == "embedding_eigh":
        return EmbeddingEighOperator((torch.rand((3, 5), generator=gen, **kw) + 0.5).to(cuda), orth(3, 3))
    if kind == "eigh":
        lam = (torch.rand(12, generator=gen, **kw) + 0.5).to(cuda)
        return EighDecomposedLinearOperator(lam, KroneckerProductLinearOperator(orth(3, 3), orth(4, 4)))
    if kind == "blockdiag":
        return BlockDiagonalLinearOperator([KroneckerProductLinearOperator(spd(2, 2), spd(3, 3)),
                                            MatrixLinearOperator(spd(4, 4))])
    if kind == "submatrix":
        idx = [0, 2, 3, 5, 7]
        return SubmatrixLinearOperator(MatrixLinearOperator(spd(9, 9)), idx, idx)
    ops, _ = _solver_case(cuda)
    G, J = ops["fused"]
    if kind == "held":
        return G._A.linearized()  # G is the GGN + 0.1 I
    return J.adjoint() @ J  # "jacobian": J^T J over the held batches


CAPTURABLE_KINDS = ["kfac", "kfac_exact", "kfac_rank", "ekfac", "kfoc", "kron", "stacked_kron",
                    "stacked_eigh", "embedding_kron", "embedding_eigh", "eigh", "blockdiag",
                    "submatrix", "held", "jacobian"]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", CAPTURABLE_KINDS)
def test_capturable_operator_in_neumann_on_card(cuda, kind):
    """Each class marked ``capturable`` is captured inside a Neumann series
    (one graph) and equals the same series run eagerly over it (float64,
    1e-10)."""
    from curvlinops_tpu_torch import NeumannInverseLinearOperator

    A = _capturable_operator(kind, cuda)
    assert A.capturable
    V = torch.randn((A.shape[1], 2), generator=torch.Generator().manual_seed(6),
                    dtype=torch.float64).to(cuda)
    scale = 0.5 / float(torch.linalg.matrix_norm(A @ torch.eye(A.shape[1], dtype=torch.float64,
                                                                 device=cuda), ord=2))
    captured = NeumannInverseLinearOperator(A, num_terms=6, scale=scale)
    eager = NeumannInverseLinearOperator(_uncaptured(A), num_terms=6, scale=scale)
    x, ref = captured @ V, eager @ V
    (program,) = [p for p in captured._program_cache[1].values() if hasattr(p, "_graph")]
    assert program._graph is not None and "_program_cache" not in eager.__dict__
    assert rel_err(x, ref) < 1e-10


@pytest.mark.cuda
def test_host_read_in_a_step_raises_naming_the_program_on_card(cuda):
    """An operator marked ``capturable`` whose product reads the host: the
    CG solve's and LOBPCG's captures raise ``RuntimeError`` naming the
    program and the way out, and the card stays usable."""
    from curvlinops_tpu_torch import CGInverseLinearOperator, MatrixLinearOperator
    from curvlinops_tpu_torch.solvers.eigsh import topk_eigenpairs

    class HostRead(MatrixLinearOperator):
        def _matmat(self, M):
            if float(M.abs().sum()) < 0:  # a host read: refused under capture
                M = -M
            return super()._matmat(M)

    gen = torch.Generator().manual_seed(7)
    M = torch.randn((30, 30), generator=gen, dtype=torch.float64)
    A = HostRead((M @ M.T / 30 + torch.eye(30, dtype=torch.float64)).to(cuda))
    A.SELF_ADJOINT = True
    with pytest.raises(RuntimeError, match="(?s)Capturing the CG solve as a CUDA graph failed.*capturable"):
        CGInverseLinearOperator(A, maxiter=5) @ torch.ones(30, dtype=torch.float64, device=cuda)
    with pytest.raises(RuntimeError, match="(?s)Capturing LOBPCG as a CUDA graph failed.*capture=False"):
        topk_eigenpairs(A, 2, maxiter=5)
    assert float(torch.ones(3, device=cuda).sum()) == 3.0
    w, _ = topk_eigenpairs(A, 2, maxiter=5, capture=False)
    assert torch.isfinite(w).all()
