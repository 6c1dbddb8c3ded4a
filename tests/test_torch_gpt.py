"""The port's nanoGPT and KFAC on it against the JAX package.

A small GPT (block 128, vocab 64, 2 layers, 2 heads, width 32; JAX's flash
kernel needs ``T >= 128`` at its default blocks) with the JAX package's
initialisation plus seeded numpy noise, so that biases and norms are not
trivial. The same weights and tokens go through ``curvlinops_tpu.models.gpt``
and ``curvlinops_tpu_torch.models.gpt``; JAX's flash kernel runs in interpret
mode on the CPU, the port's flash Function computes its plain versions on
CPU tensors. All float32.
"""

import functools

import jax
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from curvlinops_tpu.kfac.operator import KFACLinearOperator as JKFAC
from curvlinops_tpu.losses import CrossEntropyLoss as JCrossEntropyLoss
from curvlinops_tpu.models import gpt as jgpt
from curvlinops_tpu.models import resnet as jresnet
from curvlinops_tpu_torch.kfac.operator import KFACLinearOperator
from curvlinops_tpu_torch.losses import CrossEntropyLoss
from curvlinops_tpu_torch.models import flash_attention as tfa
from curvlinops_tpu_torch.models import gpt as tgpt
from curvlinops_tpu_torch.models.common import from_jax_params, to_jax_params
from curvlinops_tpu_torch.models.resnet import kfac_restricted
from tests.test_torch_helpers import (
    assert_close,
    capped_torch_threads,
    jax_gpt_init,
    jax_name,
    rel_fro,
    jax_apply,
)

_threads = capped_torch_threads()

GEOMETRY = dict(block_size=128, vocab_size=64, n_layer=2, n_head=2, n_embd=32)
BATCH = 2
# logits: float32 sums in another order (measured 4e-6 abs on logits of ~4)
LOGIT_RTOL, LOGIT_ATOL = 1e-5, 2e-5
# relative Frobenius, as in test_torch_kfac.py: factors and matvecs are
# float32 sums in another order; the heuristic inverse amplifies that
FACTOR_TOL, MATVEC_TOL, INVERSE_TOL = 1e-4, 1e-4, 1e-3


def _jax_config(impl: str) -> jgpt.GPTConfig:
    return jgpt.GPTConfig(**GEOMETRY, attention_impl=impl)


def _port_model(params_np: dict, impl: str) -> tgpt.GPT:
    model = tgpt.GPT(tgpt.GPTConfig(**GEOMETRY, attention_impl=impl))
    model.load_state_dict(from_jax_params(params_np, model))
    return model


def _jax_kfac(params_np, X, y, impl: str, fisher_type: str):
    fn = jax.tree_util.Partial(jgpt.gpt_apply, config=_jax_config(impl))
    kfac_fn, kfac_params = jresnet.kfac_restricted(fn, params_np)
    with pltpu.force_tpu_interpret_mode():
        op = JKFAC(
            kfac_fn, JCrossEntropyLoss("mean"), kfac_params, [(X, y)],
            fisher_type=fisher_type, check_deterministic=False,
        )
    return op, kfac_params


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(0)
    params = jax_gpt_init(_jax_config("einsum"))
    params_np = jax.tree.map(
        lambda a: np.asarray(a) + 0.1 * rng.standard_normal(a.shape).astype(np.float32), params
    )
    tokens = rng.integers(0, GEOMETRY["vocab_size"], size=(BATCH, GEOMETRY["block_size"] + 1))
    X, y = tokens[:, :-1], tokens[:, 1:].reshape(-1)
    return {"params": params_np, "X": X, "y": y}


@pytest.fixture(scope="module")
def kfac_case(case):
    """JAX operators built once: empirical at flash, type-2 at einsum (JAX's
    flash kernel is reverse-mode only, like the port's)."""
    ops = {}
    for impl, fisher_type in (("flash", "empirical"), ("einsum", "type-2")):
        ops[fisher_type], kfac_params = _jax_kfac(
            case["params"], case["X"], case["y"], impl, fisher_type
        )
    model = _port_model(case["params"], "flash")
    rng = np.random.default_rng(1)
    v_jax = {k: rng.standard_normal(np.shape(p)).astype(np.float32) for k, p in kfac_params.items()}
    return {
        "jax_ops": ops,
        "model": model,
        "kfac_params": from_jax_params(jax.tree.map(np.asarray, kfac_params), model),
        "data": [(torch.from_numpy(case["X"]), torch.from_numpy(case["y"]))],
        "v_jax": v_jax,
        "v": from_jax_params(v_jax, model),
    }


@pytest.mark.parametrize("impl", ["einsum", "flash"])
def test_logits_match_jax(case, impl):
    # one jitted call, waited for: op by op, the next eager op (a layer
    # norm on the attention's output) can deadlock against the interpret
    # mode's io_callbacks, which dispatch JAX ops of their own
    apply = jax.jit(functools.partial(jgpt.gpt_apply, config=_jax_config(impl)))
    with pltpu.force_tpu_interpret_mode():
        expected = jax.block_until_ready(apply(case["params"], case["X"]))
    model = _port_model(case["params"], impl)
    with torch.no_grad():
        actual = model(torch.from_numpy(case["X"]))
    assert actual.shape == (BATCH * GEOMETRY["block_size"], GEOMETRY["vocab_size"])
    assert_close(actual, expected, LOGIT_RTOL, LOGIT_ATOL, f"logits ({impl})")


def test_from_jax_params_round_trip(case):
    """Dense kernels are transposed, embedding tables (the ``weight`` of the
    ``nn.Embedding`` modules ``wte``/``wpe``) and norm parameters pass
    unchanged, and the mapping inverts exactly."""
    model = _port_model(case["params"], "einsum")
    named = from_jax_params(case["params"], model)
    assert named["wte.weight"].shape == (GEOMETRY["vocab_size"], GEOMETRY["n_embd"])
    assert named["wpe.weight"].shape == (GEOMETRY["block_size"], GEOMETRY["n_embd"])
    np.testing.assert_array_equal(named["wte.weight"].numpy(), case["params"]["wte"])
    np.testing.assert_array_equal(named["h1.ln2.scale"].numpy(), case["params"]["h1"]["ln2"]["scale"])
    np.testing.assert_array_equal(named["h0.mlp_fc.weight"].numpy(), case["params"]["h0"]["mlp_fc"]["W"].T)
    back = to_jax_params(named, model)
    flat, _ = jax.tree_util.tree_flatten_with_path(back)
    expected = dict(jax.tree_util.tree_flatten_with_path(case["params"])[0])
    assert len(flat) == len(expected)
    for path, arr in flat:
        np.testing.assert_array_equal(arr, expected[path], err_msg=jax.tree_util.keystr(path))


def _pairs(jop, top):
    port = {g.key: gi for gi, g in enumerate(top.groups)}
    pairs = []
    for gi, g in enumerate(jop.groups):
        key = (
            None if g.weight_path is None else jax_name(g.weight_path),
            None if g.bias_path is None else jax_name(g.bias_path),
        )
        pairs.append((gi, port.pop(key)))
    assert not port, f"port groups without a JAX counterpart: {list(port)}"
    return pairs


def _assert_factors_match(jop, top):
    pairs = _pairs(jop, top)
    assert len(pairs) == 4 * 2 * GEOMETRY["n_layer"]  # 4 dense layers, weight and bias each
    for jgi, tgi in pairs:
        assert (jgi in jop._aaT) == (tgi in top._aaT)
        if jgi in jop._aaT:
            assert rel_fro(top._aaT[tgi], jop._aaT[jgi]) < FACTOR_TOL, top.groups[tgi].name
        assert rel_fro(top._ggT[tgi], jop._ggT[jgi]) < FACTOR_TOL, top.groups[tgi].name


@pytest.fixture(scope="module")
def empirical_op(kfac_case):
    return KFACLinearOperator(
        kfac_case["model"], CrossEntropyLoss("mean"), kfac_case["kfac_params"],
        kfac_case["data"], fisher_type="empirical",
    )


def test_kfac_empirical_factors_match_jax_flash(kfac_case, empirical_op):
    """KFAC on the flash GPT, empirical Fisher, against JAX's at flash; the
    loss terms per example (``T``) are inferred."""
    assert empirical_op._computer.num_per_example_loss_terms == GEOMETRY["block_size"]
    _assert_factors_match(kfac_case["jax_ops"]["empirical"], empirical_op)


@pytest.mark.parametrize("mode", ["matvec", "inv_heuristic"])
def test_kfac_matvec_and_inverse_match_jax_flash(kfac_case, empirical_op, mode):
    jop = kfac_case["jax_ops"]["empirical"]
    if mode == "matvec":
        jA, tA, tol = jop, empirical_op, MATVEC_TOL
    else:
        jA = jop.inverse(damping=1e-3, use_heuristic_damping=True)
        tA = empirical_op.inverse(damping=1e-3, use_heuristic_damping=True)
        tol = INVERSE_TOL
    actual, expected = tA @ kfac_case["v"], jax_apply(jA, kfac_case["v_jax"])
    expected = from_jax_params(jax.tree.map(np.asarray, expected), kfac_case["model"])
    assert sorted(actual) == sorted(expected)
    for name in expected:
        err = rel_fro(actual[name].detach().numpy(), expected[name].numpy())
        assert err < tol, f"{mode} {name}: relative error {err}"


def test_kfac_type2_flash_matches_jax_einsum(kfac_case):
    """type-2 backpropagates one vector per class (64) through the flash
    Function in one batched backward: its vmap rule folds them into the
    batch, once per layer."""
    calls = {"n": 0}
    rule = tfa._FlashAttentionBackward.vmap

    def spy(*args):
        calls["n"] += 1
        return rule(*args)

    tfa._FlashAttentionBackward.vmap = staticmethod(spy)
    try:
        top = KFACLinearOperator(
            kfac_case["model"], CrossEntropyLoss("mean"), kfac_case["kfac_params"],
            kfac_case["data"], fisher_type="type-2",
        )
    finally:
        tfa._FlashAttentionBackward.vmap = staticmethod(rule)
    assert calls["n"] == GEOMETRY["n_layer"]
    _assert_factors_match(kfac_case["jax_ops"]["type-2"], top)


def test_shakespeare_nanogpt_problem():
    """The tiny problem builds on the CPU when asked, with the JAX package's
    KFAC selection: the four dense layers of each block, weight and bias,
    without the embeddings, norms and ``lm_head``."""
    problem = tgpt.shakespeare_nanogpt(
        batch_size=2, config=tgpt.TINY_GPT, device="cpu", attention_impl="flash"
    )
    assert problem.model.config.attention_impl == "flash"
    names = list(problem.kfac_params)
    assert len(names) == 4 * 2 * tgpt.TINY_GPT.n_layer
    assert all(n.split(".")[1] in ("attn_qkv", "attn_proj", "mlp_fc", "mlp_proj") for n in names)
    X, y = problem.data[0]
    T = tgpt.TINY_GPT.block_size
    assert X.shape == (2, T) and y.shape == (2 * T,)
    assert problem.model(X).shape == (2 * T, tgpt.TINY_GPT.vocab_size)


def test_gpt2_small_kfac_selection():
    """At full width KFAC covers the 48 dense layers, 85,017,600 parameters
    (``lm_head``'s 50304-wide dim is over the 50k cut); built on the meta
    device, so no weights are allocated."""
    with torch.device("meta"):
        model = tgpt.GPT(tgpt.GPTConfig())
    _, kfac_params = kfac_restricted(model)
    assert len(kfac_params) == 96
    assert sum(p.numel() for p in kfac_params.values()) == 85_017_600


def test_attention_impls():
    """``"fused"`` (SDPA with its math backend pinned) builds; an unknown
    name is refused."""
    model = tgpt.GPT(tgpt.GPTConfig(**GEOMETRY, attention_impl="fused"))
    assert model.h0.attention_impl == "fused"
    with pytest.raises(ValueError, match="attention_impl"):
        tgpt.GPT(tgpt.GPTConfig(**GEOMETRY, attention_impl="dense"))
