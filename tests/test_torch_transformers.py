"""The transformer family against the JAX package: the scan-stacked GPT
(einsum, flash and fused attention), the ViT (unrolled and stacked), the
fused GPT's GGN and Hessian, KFAC on the ViT, and ``remat_blocks``.

The same numpy weights and inputs go through ``curvlinops_tpu.models`` and
``curvlinops_tpu_torch.models``; weights cross with ``from_jax_params``.
JAX's flash kernel runs in interpret mode as one ``jax.jit`` call followed
by ``jax.block_until_ready`` (op by op it deadlocks), at the block size of
``tests/test_torch_gpt.py`` (``T = 128``, which it needs). All float32;
tolerances those of ``tests/test_torch_gpt.py``.
"""

import functools

import jax
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from curvlinops_tpu.curvature.ggn import GGNLinearOperator as JGGN
from curvlinops_tpu.curvature.hessian import HessianLinearOperator as JHessian
from curvlinops_tpu.kfac.operator import KFACLinearOperator as JKFAC
from curvlinops_tpu.losses import CrossEntropyLoss as JCrossEntropyLoss
from curvlinops_tpu.models import gpt as jgpt
from curvlinops_tpu.models import resnet as jresnet
from curvlinops_tpu.models import vit as jvit
from curvlinops_tpu_torch.curvature.ggn import GGNLinearOperator
from curvlinops_tpu_torch.curvature.hessian import HessianLinearOperator
from curvlinops_tpu_torch.kfac.kernels import conv_cov_kernel_supported
from curvlinops_tpu_torch.kfac.operator import KFACLinearOperator
from curvlinops_tpu_torch.losses import CrossEntropyLoss
from curvlinops_tpu_torch.models import gpt as tgpt
from curvlinops_tpu_torch.models import vit as tvit
from curvlinops_tpu_torch.models.common import from_jax_params, to_jax_params
from curvlinops_tpu_torch.models.resnet import kfac_restricted
from tests.test_torch_gpt import GEOMETRY, LOGIT_ATOL, LOGIT_RTOL, MATVEC_TOL
from tests.test_torch_helpers import (
    assert_close,
    capped_torch_threads,
    jax_apply,
    jax_gpt_init,
    rel_fro,
)

_threads = capped_torch_threads()

BATCH = 2


def _noisy(params, seed=0):
    """JAX's initialisation plus seeded noise, so biases and norms are not trivial."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: np.asarray(a) + 0.1 * rng.standard_normal(a.shape).astype(np.float32), params
    )


@pytest.fixture(scope="module")
def gpt_case():
    config = jgpt.GPTConfig(**GEOMETRY)
    params = _noisy(jax_gpt_init(config))
    stacked = jax.tree.map(np.asarray, jgpt.stack_gpt_blocks(params, config))
    rng = np.random.default_rng(3)
    X = rng.integers(0, GEOMETRY["vocab_size"], size=(BATCH, GEOMETRY["block_size"]))
    return {"params": params, "stacked": stacked, "X": X}


def _port_gpt(params_np, impl, scan_blocks, geometry=GEOMETRY, remat=False):
    model = tgpt.GPT(tgpt.GPTConfig(**geometry, attention_impl=impl), scan_blocks, remat)
    model.load_state_dict(from_jax_params(params_np, model))
    return model


@pytest.mark.parametrize("impl", ["einsum", "flash", "fused"])
def test_stacked_gpt_logits_match_jax(gpt_case, impl):
    """The scan-stacked GPT against JAX's ``lax.scan`` GPT, and against the
    port's unrolled GPT with the same weights."""
    apply = jax.jit(functools.partial(
        jgpt.gpt_apply, config=jgpt.GPTConfig(**GEOMETRY, attention_impl=impl)
    ))
    with pltpu.force_tpu_interpret_mode():
        expected = jax.block_until_ready(apply(gpt_case["stacked"], gpt_case["X"]))
    X = torch.from_numpy(gpt_case["X"])
    with torch.no_grad():
        actual = _port_gpt(gpt_case["stacked"], impl, True)(X)
        unrolled = _port_gpt(gpt_case["params"], impl, False)(X)
    assert actual.shape == (BATCH * GEOMETRY["block_size"], GEOMETRY["vocab_size"])
    assert_close(actual, expected, LOGIT_RTOL, LOGIT_ATOL, f"stacked logits ({impl})")
    assert torch.equal(actual, unrolled)


def test_stacked_gpt_params_round_trip(gpt_case):
    """The stacked ``h`` subtree maps to the stacked modules (each dense
    slice transposed) and back exactly; ``stack_gpt_blocks`` stacks the
    unrolled port model as JAX stacks its tree."""
    model = _port_gpt(gpt_case["stacked"], "einsum", True)
    named = from_jax_params(gpt_case["stacked"], model)
    W = gpt_case["stacked"]["h"]["mlp_fc"]["W"]  # [L, C, 4C]
    np.testing.assert_array_equal(named["h.mlp_fc.weight"].numpy(), W.transpose(0, 2, 1))
    np.testing.assert_array_equal(named["h.ln1.scale"].numpy(),
                                  gpt_case["stacked"]["h"]["ln1"]["scale"])
    _assert_tree_equal(to_jax_params(named, model), gpt_case["stacked"])
    from_unrolled = tgpt.stack_gpt_blocks(_port_gpt(gpt_case["params"], "einsum", False))
    _assert_tree_equal(to_jax_params(dict(from_unrolled.named_parameters()), from_unrolled),
                       gpt_case["stacked"])


def _assert_tree_equal(actual, expected):
    flat = dict(jax.tree_util.tree_flatten_with_path(actual)[0])
    want = dict(jax.tree_util.tree_flatten_with_path(expected)[0])
    assert flat.keys() == want.keys()
    for path, arr in want.items():
        np.testing.assert_array_equal(flat[path], arr, err_msg=jax.tree_util.keystr(path))


# ---------------------------------------------------------------------- #
# the ViT
# ---------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def vit_case():
    config = jvit.TINY_VIT
    params = _noisy(jvit.init_vit(jax.random.key(1), config))
    rng = np.random.default_rng(4)
    X = rng.uniform(size=(BATCH, config.image_size, config.image_size, 3)).astype(np.float32)
    y = rng.integers(0, config.num_classes, size=BATCH)
    return {
        "params": params, "stacked": jax.tree.map(np.asarray, jvit.stack_vit_blocks(params, config)),
        "X": X, "y": y, "X_t": torch.from_numpy(X).permute(0, 3, 1, 2).contiguous(),
    }


def _port_vit(params_np, scan_blocks):
    model = tvit.ViT(tvit.TINY_VIT, scan_blocks)
    model.load_state_dict(from_jax_params(params_np, model))
    return model


@pytest.mark.parametrize("scan_blocks", [False, True], ids=["unrolled", "stacked"])
def test_vit_logits_and_params_match_jax(vit_case, scan_blocks):
    """ViT logits on NCHW images against JAX's on NHWC; the patch conv's
    HWIO kernel, the CLS token, the position table and the head map across
    and back exactly."""
    params = vit_case["stacked"] if scan_blocks else vit_case["params"]
    expected = jvit.vit_apply(params, vit_case["X"], config=jvit.TINY_VIT)
    model = _port_vit(params, scan_blocks)
    with torch.no_grad():
        actual = model(vit_case["X_t"])
    assert actual.shape == (BATCH, tvit.TINY_VIT.num_classes)
    assert_close(actual, expected, LOGIT_RTOL, LOGIT_ATOL, "ViT logits")
    named = dict(model.named_parameters())
    np.testing.assert_array_equal(
        named["conv_patch.weight"].detach().numpy(),
        params["conv_patch"]["W"].transpose(3, 2, 0, 1),
    )
    _assert_tree_equal(to_jax_params(named, model), params)


@pytest.mark.parametrize("scan_blocks", [False, True], ids=["unrolled", "stacked"])
def test_vit_kfac_matches_jax(vit_case, scan_blocks):
    """KFAC on the ViT (the patch conv, stacked or unrolled dense blocks, the
    head) against JAX's; the patch conv (``kh*kw = 16``, ``C = 3``) fails
    the conv kernel's eligibility gate and takes the plain path."""
    params = vit_case["stacked"] if scan_blocks else vit_case["params"]
    fn = jax.tree_util.Partial(jvit.vit_apply, config=jvit.TINY_VIT)
    jfn, jp = jresnet.kfac_restricted(fn, params)
    jop = JKFAC(jfn, JCrossEntropyLoss("mean"), jp, [(vit_case["X"], vit_case["y"])],
                fisher_type="type-2", check_deterministic=False)
    model = _port_vit(params, scan_blocks)
    _, p = kfac_restricted(model)
    op = KFACLinearOperator(model, CrossEntropyLoss("mean"), p,
                            [(vit_case["X_t"], torch.from_numpy(vit_case["y"]))],
                            fisher_type="type-2", use_kernel=True)
    conv = next(g for g in op.groups if g.uses[0].kind == "conv")
    assert not conv_cov_kernel_supported(tuple(vit_case["X_t"].shape), conv.uses[0].meta)
    blocks = [g for g in op.groups if g.weight_path not in (None, "conv_patch.weight", "fc.weight")]
    n_layer = tvit.TINY_VIT.n_layer
    assert [g.stack for g in blocks] == ([n_layer] * 4 if scan_blocks else [0] * 4 * n_layer)
    rng = np.random.default_rng(1)
    v_jax = {k: rng.standard_normal(np.shape(a)).astype(np.float32) for k, a in jp.items()}
    v = from_jax_params(v_jax, model)
    out = op @ {n: v[n] for n in p}
    expected = from_jax_params(jax_apply(jop, v_jax), model)
    for name in expected:
        assert rel_fro(out[name].detach().numpy(), expected[name].numpy()) < MATVEC_TOL, name


# ---------------------------------------------------------------------- #
# "fused" attention under forward mode, and remat
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("op_name", ["ggn", "hessian"])
def test_fused_gpt_curvature_matches_jax(op_name):
    """The GGN and the Hessian of the stacked fused GPT (SDPA's math
    backend, forward mode through it) against JAX's fused GPT's, and against
    the port's einsum GPT."""
    config = jgpt.TINY_GPT
    params = jax.tree.map(
        np.asarray, jgpt.stack_gpt_blocks(_noisy(jax_gpt_init(config)), config)
    )
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, config.vocab_size, size=(BATCH, config.block_size + 1))
    X, y = tokens[:, :-1], tokens[:, 1:].reshape(-1)
    jcls, cls = {"ggn": (JGGN, GGNLinearOperator), "hessian": (JHessian, HessianLinearOperator)}[op_name]
    fn = jax.tree_util.Partial(jgpt.gpt_apply, config=jgpt.GPTConfig(
        **{**config.__dict__, "attention_impl": "fused"}))
    A_j = jcls(fn, JCrossEntropyLoss("mean"), params, [(X, y)], check_deterministic=False)
    geometry = {k: v for k, v in config.__dict__.items() if k != "attention_impl"}
    v_j = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32), params)
    out_j = None
    for impl in ("fused", "einsum"):
        model = _port_gpt(params, impl, True, geometry)
        A = cls(model, CrossEntropyLoss("mean"), dict(model.named_parameters()),
                [(torch.from_numpy(X), torch.from_numpy(y))])
        v = from_jax_params(v_j, model)
        out = A @ {n: v[n] for n in A.in_spec}
        flat = torch.cat([out[n].reshape(-1) for n in out])
        if out_j is None:
            expected = from_jax_params(jax_apply(A_j, v_j), model)
            out_j = torch.cat([expected[n].reshape(-1) for n in out])
            fused = flat
            assert rel_fro(flat, out_j) < MATVEC_TOL, f"{op_name} vs JAX"
        else:
            assert rel_fro(fused, flat) < MATVEC_TOL, f"{op_name} fused vs einsum"


def test_remat_blocks_factors_and_ggn_unchanged():
    """``remat_blocks`` on the stacked GPT and the stacked ViT: the same KFAC
    factors (the collector's forward runs the loop without recomputation)
    and the same GGN matvec (its ``torch.func`` transforms recompute each
    block in the pullback; ``tests/test_torch_remat.py`` counts the
    recomputes)."""
    builds = {
        "gpt": lambda remat: tgpt.shakespeare_nanogpt(
            batch_size=BATCH, config=tgpt.TINY_GPT, device="cpu", scan_blocks=True,
            remat_blocks=remat, include_embeddings=True),
        "vit": lambda remat: tvit.cifar10_vit(
            batch_size=BATCH, config=tvit.TINY_VIT, device="cpu", scan_blocks=True,
            remat_blocks=remat),
    }
    for build in builds.values():
        results = []
        for remat in (False, True):
            problem = build(remat)
            assert problem.model.remat_blocks is remat
            kfac = KFACLinearOperator(problem.model, problem.loss_fn, problem.kfac_params,
                                      problem.data, fisher_type="mc", mc_samples=2)
            ggn = GGNLinearOperator(problem.model, problem.loss_fn, problem.params, problem.data)
            v = torch.randn(ggn.shape[1], generator=torch.Generator().manual_seed(0))
            results.append((kfac._aaT, kfac._ggT, ggn @ v))
        (a0, g0, m0), (a1, g1, m1) = results
        assert all(torch.equal(a0[k], a1[k]) for k in a0)
        assert all(torch.equal(g0[k], g1[k]) for k in g0)
        assert torch.allclose(m0, m1, rtol=1e-6, atol=1e-7)


def test_remat_recomputes_under_plain_autograd():
    """Under plain autograd ``remat_blocks`` recomputes each block in
    backward: a forward hook on a block layer fires a second time there,
    which is why the KFAC collector runs the loop without it."""
    calls = []
    for remat in (False, True):
        problem = tgpt.shakespeare_nanogpt(batch_size=BATCH, config=tgpt.TINY_GPT, device="cpu",
                                           scan_blocks=True, remat_blocks=remat)
        model = problem.model
        n = [0]
        handle = model.h.mlp_fc.register_forward_hook(lambda *_: n.__setitem__(0, n[0] + 1))
        X, y = problem.data[0]
        problem.loss_fn(model(X), y).backward()
        handle.remove()
        calls.append(n[0])
    assert calls == [tgpt.TINY_GPT.n_layer, 2 * tgpt.TINY_GPT.n_layer]


@pytest.mark.parametrize("build", ["cifar10_vit", "stacked_nanogpt"])
def test_new_problems_default_to_the_card(build):
    """The new entry points build on a CUDA device unless the caller asks for
    the CPU, and refuse when there is none."""
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without a CUDA device")
    make = {
        "cifar10_vit": lambda **kw: tvit.cifar10_vit(batch_size=2, config=tvit.TINY_VIT, **kw),
        "stacked_nanogpt": lambda **kw: tgpt.shakespeare_nanogpt(
            batch_size=2, config=tgpt.TINY_GPT, scan_blocks=True, **kw),
    }[build]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make()
    problem = make(device="cpu")
    X, _ = problem.data[0]
    assert torch.isfinite(problem.model(X)).all()
