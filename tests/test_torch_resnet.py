"""ResNet port against the JAX package: logits, BN calibration, weights across.

All comparisons are float32 on the CPU; tolerances are stated per test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from curvlinops_tpu.models import resnet as jresnet
from curvlinops_tpu_torch.models import gpt as tgpt
from curvlinops_tpu_torch.models import resnet as tresnet
from tests.test_torch_helpers import assert_close, narrow_resnet


@pytest.fixture(scope="module")
def case():
    return narrow_resnet()


def test_resnet_logits_match_jax(case):
    """Same weights and inputs give the same logits (rtol 1e-5, atol 1e-5:
    float32 convolutions summed in another order)."""
    expected = case["apply_fn"](case["jax_params"], jnp.asarray(case["X_nhwc"]))
    with torch.no_grad():
        actual = case["model"](case["X"])
    assert_close(actual, expected, rtol=1e-5, atol=1e-5, name="logits")


def test_calibrate_bn_matches_jax(case):
    """Folded BN affines from one batch agree per site (rtol 1e-4, atol 1e-5)."""
    model = tresnet.ResNet("basic", (1, 1, 1, 1), (16, 16, 32, 32), 10, stem_width=16)
    model.load_state_dict(tresnet.from_jax_params(case["jax_uncalibrated"], model))
    affines = tresnet.calibrate_bn(model, case["X_calib"])
    expected = tresnet.from_jax_params(jax.tree.map(np.asarray, case["jax_params"]), model)
    bn_names = [n for n in expected if ".scale" in n or (n.split(".")[-2].startswith("bn"))]
    assert sorted(affines) == sorted(bn_names)
    for name in bn_names:
        assert_close(affines[name], expected[name], rtol=1e-4, atol=1e-5, name=name)
    # returned, not applied: the model still holds the uncalibrated affines
    assert torch.equal(model.bn1.scale, torch.ones(16))


def test_from_jax_params_round_trip(case):
    """JAX tree -> named tensors -> JAX tree is exact, and HWIO/[in, out]
    leaves become OIHW/[out, in]."""
    params_np = jax.tree.map(np.asarray, case["jax_params"])
    named = tresnet.from_jax_params(params_np, case["model"])
    assert named["conv1.weight"].shape == (16, 3, 7, 7)
    assert named["fc.weight"].shape == (10, 32)
    back = tresnet.to_jax_params(named, case["model"])
    flat_a = jax.tree_util.tree_flatten_with_path(params_np)[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], leaf)


@pytest.mark.parametrize(
    "size,kernel,stride", [(32, 7, 2), (16, 3, 2), (16, 1, 2), (8, 3, 1), (7, 3, 2)]
)
def test_same_pads_match_jax(size, kernel, stride):
    """The explicit (lo, hi) pads equal JAX's "SAME" pads, exactly."""
    expected = jax.lax.padtype_to_pads((size,), (kernel,), (stride,), "SAME")[0]
    assert tresnet.same_pads(size, kernel, stride) == tuple(expected)


def test_cifar10_resnet18_problem():
    """The full-width problem builds with the JAX package's KFAC selection:
    20 conv weights plus the classifier's weight and bias."""
    problem = tresnet.cifar10_resnet18(batch_size=2, device="cpu")
    names = list(problem.kfac_params)
    assert len(names) == 22 and names[-2:] == ["fc.weight", "fc.bias"]
    assert not any(".bn" in n or n.startswith("bn") for n in names)
    X, y = problem.data[0]
    assert X.shape == (2, 3, 32, 32) and y.shape == (2,)
    with torch.no_grad():
        logits = problem.model(X)
    assert logits.shape == (2, 10) and torch.isfinite(logits).all()


@pytest.mark.parametrize("make_problem", ["cifar10_resnet18", "imagenet_resnet50", "shakespeare_nanogpt"])
def test_problems_default_to_the_card(make_problem):
    """The problems build on a CUDA device unless the caller asks for the
    CPU, and refuse when there is none: no fallback to the CPU."""
    build = getattr(tgpt if make_problem == "shakespeare_nanogpt" else tresnet, make_problem)
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without a CUDA device")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build(batch_size=2)
