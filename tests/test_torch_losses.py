"""Losses and loss-Hessian structure of the port against the JAX package.

Inputs come from numpy; the JAX per-datum functions are ``vmap``-ed over the
batch to match the port's batched ones. All comparisons are float32 with
rtol 1e-5, atol 1e-6 (elementwise formulas, no long sums).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from curvlinops_tpu import losses as jlosses
from curvlinops_tpu.curvature import loss_hessian as jlh
from curvlinops_tpu_torch import losses as tlosses
from curvlinops_tpu_torch.curvature import loss_hessian as tlh
from tests.test_torch_helpers import capped_torch_threads

_threads = capped_torch_threads()

RTOL, ATOL = 1e-5, 1e-6


def _case(name: str, reduction: str, seed: int = 0):
    """(jax loss, torch loss, prediction, target) for one loss configuration."""
    rng = np.random.default_rng(seed)
    if name == "mse":
        pred = rng.standard_normal((5, 3)).astype(np.float32)
        y = rng.standard_normal((5, 3)).astype(np.float32)
        return jlosses.MSELoss(reduction), tlosses.MSELoss(reduction), pred, y
    if name == "bce":
        pred = rng.standard_normal((5, 3)).astype(np.float32)
        y = rng.uniform(size=(5, 3)).astype(np.float32)
        return jlosses.BCEWithLogitsLoss(reduction), tlosses.BCEWithLogitsLoss(reduction), pred, y
    # cross-entropy, with a trailing sharing dim and two ignored targets
    pred = rng.standard_normal((5, 4, 2)).astype(np.float32)
    y = rng.integers(0, 4, size=(5, 2))
    if name == "ce_ignore":
        y[1, 0] = y[3, 1] = -100
    return jlosses.CrossEntropyLoss(reduction), tlosses.CrossEntropyLoss(reduction), pred, y


CASES = ["mse", "bce", "ce", "ce_ignore"]


@pytest.mark.parametrize("reduction", ["mean", "sum"])
@pytest.mark.parametrize("name", CASES)
def test_loss_values_match_jax(name, reduction):
    jl, tl, pred, y = _case(name, reduction)
    expected = jl(jnp.asarray(pred), jnp.asarray(y))
    actual = tl(torch.from_numpy(pred), torch.from_numpy(y))
    np.testing.assert_allclose(actual.numpy(), np.asarray(expected), rtol=RTOL, atol=ATOL)


def test_ce_ignore_index_means_over_kept_targets():
    """All-but-one ignored: the mean is that one target's loss, not /N."""
    pred = torch.tensor([[2.0, 0.0], [0.0, 1.0], [1.0, 1.0]])
    y = torch.tensor([0, -100, -100])
    expected = -torch.log_softmax(pred[0], dim=0)[0]
    assert torch.allclose(tlosses.CrossEntropyLoss("mean")(pred, y), expected)
    assert tlosses.CrossEntropyLoss("mean")(pred, torch.full((3,), -100)) == 0


@pytest.mark.parametrize("reduction", ["mean", "sum"])
@pytest.mark.parametrize("name", CASES)
def test_loss_hessian_sqrt_columns_match_jax(name, reduction):
    jl, tl, pred, y = _case(name, reduction)
    expected = jax.vmap(lambda o, t: jlh.loss_hessian_sqrt_columns(jl, o, t))(
        jnp.asarray(pred), jnp.asarray(y)
    )
    actual = tlh.loss_hessian_sqrt_columns(tl, torch.from_numpy(pred), torch.from_numpy(y))
    np.testing.assert_allclose(actual.numpy(), np.asarray(expected), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("reduction", ["mean", "sum"])
@pytest.mark.parametrize("name", CASES)
def test_empirical_grad_output_matches_jax(name, reduction):
    jl, tl, pred, y = _case(name, reduction)
    expected = jax.vmap(lambda o, t: jlh.empirical_grad_output(jl, o, t))(
        jnp.asarray(pred), jnp.asarray(y)
    )
    actual = tlh.make_grad_output_fn(tl, tlh.FisherType.EMPIRICAL)(
        torch.from_numpy(pred), torch.from_numpy(y), None
    )
    np.testing.assert_allclose(actual.numpy(), np.asarray(expected), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", CASES)
def test_mean_rescale_matches_jax(name):
    jl, tl, _, y = _case(name, "mean")
    expected = jlh.mean_rescale(jl, jnp.asarray(y))
    actual = tlh.mean_rescale(tl, torch.from_numpy(y))
    np.testing.assert_allclose(float(actual), float(expected), rtol=RTOL)


@pytest.mark.parametrize("name", CASES)
def test_mc_and_forward_only_shapes(name):
    """MC draws ``[N, M, *datum]`` scaled by 1/sqrt(M); forward-only none."""
    _, tl, pred, y = _case(name, "mean")
    out, tgt = torch.from_numpy(pred), torch.from_numpy(y)
    gen = torch.Generator().manual_seed(0)
    mc = tlh.make_grad_output_fn(tl, tlh.FisherType.MC, mc_samples=3)(out, tgt, gen)
    assert mc.shape == (out.shape[0], 3, *out.shape[1:]) and torch.isfinite(mc).all()
    fo = tlh.make_grad_output_fn(tl, tlh.FisherType.FORWARD_ONLY)(out, tgt, gen)
    assert fo.shape == (out.shape[0], 0, *out.shape[1:])


@pytest.mark.parametrize("shape", [(2,), (6, 1)], ids=["fewer", "extra_dim"])
def test_ce_refuses_targets_not_matching_the_rows(shape):
    """Targets whose shape is not the logits' rows are refused, as JAX's
    ``take_along_axis`` refuses them, instead of reading the first rows."""
    pred = np.random.default_rng(0).standard_normal((6, 3)).astype(np.float32)
    y = np.zeros(shape, dtype=np.int64)
    with pytest.raises(ValueError, match="targets of shape"):
        tlosses.CrossEntropyLoss("mean")(torch.from_numpy(pred), torch.from_numpy(y))
    with pytest.raises((ValueError, TypeError)):
        jlosses.CrossEntropyLoss("mean")(jnp.asarray(pred), jnp.asarray(y))
