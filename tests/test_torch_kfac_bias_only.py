"""Bias-only KFAC blocks: covered biases whose weights stay in the model.

The port's twins of ``tests/test_kfac_bias_only.py``, on the same numpy
inputs as the JAX package's operators: each covered bias gets its exact
gradient-covariance block. A bias arrives as the ``bias`` of an
``nn.Linear`` whose weight is not covered, or added by ``+`` onto a tensor
no covered layer produced. The port runs in float64 and equals the dense
block-diagonal GGN to 1e-10 where the JAX test claims exactness; JAX's
float32 operators agree to 1e-5. JAX's refusals stay refusals in both
packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from curvlinops_tpu.kfac.operator import KFACLinearOperator as JKFAC
from curvlinops_tpu.losses import MSELoss as JMSELoss
from curvlinops_tpu_torch.kfac.operator import KFACLinearOperator
from curvlinops_tpu_torch.losses import MSELoss
from curvlinops_tpu_torch.models.stack import scan
from tests.test_torch_helpers import blockdiag_ggn, capped_torch_threads, rel_fro

_threads = capped_torch_threads()

RTOL, JAX_RTOL = 1e-10, 1e-5


def _weights(seed: int):
    rng = np.random.default_rng(seed)
    return 0.4 * rng.standard_normal((5, 4)), 0.4 * rng.standard_normal((4, 3))  # [in, out]


def _biases(seed: int):
    rng = np.random.default_rng(seed)
    return 0.2 * rng.standard_normal(4), 0.2 * rng.standard_normal(3)


def _data(seed: int, sizes, share=(), d_out=3):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((n, *share, 5)), rng.standard_normal((n, *share, d_out)))
            for n in sizes]


def _torch_data(data):
    return [(torch.from_numpy(X), torch.from_numpy(y)) for X, y in data]


def _jax_dense(model_fn, params: dict, data, reduction, **kw) -> np.ndarray:
    """The JAX package's KFAC matrix (float32) on the same numpy inputs."""
    f32 = lambda a: jnp.asarray(a, jnp.float32)  # noqa: E731
    op = JKFAC(model_fn, JMSELoss(reduction), jax.tree.map(f32, params),
               [(f32(X), f32(y)) for X, y in data], fisher_type="type-2",
               check_deterministic=False, **kw)
    return np.asarray(op.todense())


class Closed(nn.Module):
    """A model whose weights are buffers (closed over) and whose biases are
    parameters; ``forward`` is ``fn(self, x)``."""

    def __init__(self, fn, weights: dict, biases: dict):
        super().__init__()
        self.fn = fn
        for k, w in weights.items():
            self.register_buffer(k, torch.from_numpy(w))
        for k, b in biases.items():
            setattr(self, k, nn.Parameter(torch.from_numpy(b)))

    def forward(self, x):  # noqa: D102
        return self.fn(self, x)


def _kfac(model, params, data, reduction, **kw):
    return KFACLinearOperator(model, MSELoss(reduction), params, _torch_data(data),
                              fisher_type="type-2", **kw)


class TwoLayer(nn.Module):
    """``relu(l1(x))`` then ``l2``, as the JAX test's ``model_full``."""

    def __init__(self, W1, b1, W2, b2):
        super().__init__()
        self.l1, self.l2 = nn.Linear(5, 4, dtype=torch.float64), nn.Linear(4, 3, dtype=torch.float64)
        with torch.no_grad():
            for lin, W, b in ((self.l1, W1, b1), (self.l2, W2, b2)):
                lin.weight.copy_(torch.from_numpy(W.T))
                lin.bias.copy_(torch.from_numpy(b))

    def forward(self, x):  # noqa: D102
        return self.l2(torch.relu(self.l1(x)))


@pytest.mark.parametrize("reduction", ["mean", "sum"])
def test_bias_only_matches_full_kfac_bias_blocks(reduction):
    """KFAC over the biases of ``nn.Linear`` modules whose weights are not
    covered equals the bias blocks of the full separate-W+b KFAC, and the
    JAX package's bias-only KFAC."""
    (W1, W2), (b1, b2) = _weights(0), _biases(1)
    data = _data(2, [3, 6])
    model = TwoLayer(W1, b1, W2, b2)
    full = _kfac(model, dict(model.named_parameters()), data, reduction).todense()
    bias_params = {n: p for n, p in model.named_parameters() if n.endswith("bias")}
    bias_only = _kfac(model, bias_params, data, reduction)
    assert [g.weight_path for g in bias_only.groups] == [None, None]
    idx = np.r_[20:24, 36:39]  # l1.weight (20), l1.bias (4), l2.weight (12), l2.bias (3)
    assert rel_fro(bias_only.todense(), full[np.ix_(idx, idx)]) < RTOL

    def model_bias(p, x):
        return jax.nn.relu(x @ W1 + p["b1"]) @ W2 + p["b2"]

    expected = _jax_dense(model_bias, {"b1": b1, "b2": b2}, data, reduction)
    assert rel_fro(bias_only.todense(), expected) < JAX_RTOL


@pytest.mark.parametrize("approx", ["expand", "reduce"])
@pytest.mark.parametrize("reduction", ["mean", "sum"])
def test_bias_only_linear_exact(reduction, approx):
    """Deep linear + MSE with a weight-sharing axis: biases added by ``+``
    onto products with closed-over weights form bias-only blocks that equal
    the GGN's bias blocks exactly, and JAX's."""
    W1, W2 = _weights(3)
    b1, b2 = _biases(4)
    reduce = approx == "reduce"

    def fn(m, x):
        h = x @ m.W1 + m.b1
        if reduce:
            h = h.mean(dim=1, keepdim=True) + 0 * h[:, :1]
        return h @ m.W2 + m.b2

    def jfn(p, x):
        h = x @ W1 + p["b1"]
        if reduce:
            h = jnp.mean(h, axis=1, keepdims=True) + 0 * h[:, :1]
        return h @ W2 + p["b2"]

    data = _data(5, [2, 5], share=(7,))
    if reduce:
        data = [(X, y[:, :1]) for X, y in data]
    model = Closed(fn, {"W1": W1, "W2": W2}, {"b1": b1, "b2": b2})
    params = dict(model.named_parameters())
    kfac = _kfac(model, params, data, reduction, kfac_approx=approx)
    expected = blockdiag_ggn(model, MSELoss(reduction), params, _torch_data(data), kfac.groups)
    assert rel_fro(kfac.todense(), expected) < RTOL
    jexpected = _jax_dense(jfn, {"b1": b1, "b2": b2}, data, reduction, kfac_approx=approx)
    assert rel_fro(kfac.todense(), jexpected) < JAX_RTOL


def test_tied_bias_only_merges():
    """One bias added at two parallel sites forms one merged group, exactly
    twice the block of the single-site model (the second site's bias a
    closed-over constant): per-site ``ggT`` accumulation."""
    W1, _ = _weights(6)
    b = 0.1 * np.random.default_rng(7).standard_normal(4)

    def tied(m, x):
        return (x @ m.W1 + m.b) + (x @ m.W1 + m.b)

    def single(m, x):
        return (x @ m.W1 + m.b) + (x @ m.W1 + m.c)

    data = _data(8, [4], d_out=4)
    m_tied = Closed(tied, {"W1": W1}, {"b": b})
    m_single = Closed(single, {"W1": W1, "c": b}, {"b": b})
    k_tied = _kfac(m_tied, dict(m_tied.named_parameters()), data, "mean")
    k_single = _kfac(m_single, dict(m_single.named_parameters()), data, "mean")
    assert len(k_tied.groups) == 1 and len(k_tied.groups[0].uses) == 2
    assert rel_fro(k_tied.todense(), 2.0 * k_single.todense()) < RTOL

    def jtied(p, x):
        return (x @ W1 + p["b"]) + (x @ W1 + p["b"])

    assert rel_fro(k_tied.todense(), _jax_dense(jtied, {"b": b}, data, "mean")) < JAX_RTOL


def _refused_by_both(model, jfn, params: dict, data, match: str):
    with pytest.raises(ValueError, match=match):
        _kfac(model, {n: p for n, p in model.named_parameters() if n in params}, data, "mean")
    with pytest.raises(ValueError):
        _jax_dense(jfn, params, data, "mean")


def test_chained_bias_readd_refused():
    """Re-adding a bias-only block's bias along its own output is refused:
    one gradient tap cannot model both sites."""
    W1, W2 = _weights(6)
    b = 0.1 * np.random.default_rng(7).standard_normal(4)

    def fn(m, x):
        h = x @ m.W1 + m.b
        return (h @ m.W2[:, :1] + (h + m.b) @ m.W2[:, 1:2]).sum(-1)

    def jfn(p, x):
        h = x @ W1 + p["b"]
        return (h @ W2[:, :1] + (h + p["b"]) @ W2[:, 1:2]).sum(-1)

    data = [(X, y[:, 0]) for X, y in _data(9, [4])]
    _refused_by_both(Closed(fn, {"W1": W1, "W2": W2}, {"b": b}), jfn, {"b": b}, data,
                     "more than once")


def test_bias_only_refusals():
    """A ``(3,)`` leaf broadcast over the batch, not the features, is refused."""
    W1, _ = _weights(10)

    def fn(m, x):
        return (x @ m.W1) + m.b[:, None]

    def jfn(p, x):
        return (x @ W1) + p["b"][:, None]

    data = _data(11, [3], d_out=4)
    _refused_by_both(Closed(fn, {"W1": W1}, {"b": np.ones(3)}), jfn, {"b": np.ones(3)}, data,
                     "bias with 3 elements")


def test_bias_added_twice_to_same_layer_refused():
    """``x @ W + b + b`` with ``W`` covered refuses: one homogeneous bias per
    layer, and re-attaching it would model only one add."""

    def fn(m, x):
        return x @ m.W + m.b + m.b

    def jfn(p, x):
        return x @ p["W"] + p["b"] + p["b"]

    params = {"W": np.ones((5, 4)), "b": np.ones(4)}
    data = _data(13, [3], d_out=4)
    _refused_by_both(Closed(fn, {}, params), jfn, params, data, "more than once")


class _ScannedBias(nn.Module):
    """``h -> h @ W + b`` for two loop steps, the bias added by ``+`` or as
    an ``nn.Linear``'s own bias (its weight not covered)."""

    def __init__(self, via_module: bool):
        super().__init__()
        self.lin = nn.Linear(4, 4, dtype=torch.float64)
        self.register_buffer("W", torch.eye(4, dtype=torch.float64))
        self.b = nn.Parameter(torch.zeros(4, dtype=torch.float64))
        self.via_module = via_module

    def forward(self, x):  # noqa: D102
        step = self.lin if self.via_module else (lambda h: h @ self.W + self.b)
        return scan(lambda h, _: step(h), x, 2)


@pytest.mark.parametrize("via", ["add", "module"])
def test_bias_only_inside_scan_refused(via):
    """A bias-only block inside a scan is refused, as the JAX collector
    refuses it (``lax.scan`` body)."""
    model = _ScannedBias(via == "module")
    name = "lin.bias" if via == "module" else "b"
    data = [(np.random.default_rng(14).standard_normal((3, 4)),
             np.random.default_rng(15).standard_normal((3, 4)))]
    with pytest.raises(ValueError, match="inside a scan"):
        _kfac(model, {name: dict(model.named_parameters())[name]}, data, "mean")

    def jfn(p, x):
        def body(h, _):
            return h @ jnp.eye(4) + p["b"], None

        return jax.lax.scan(body, x, None, length=2)[0]

    with pytest.raises(ValueError):
        _jax_dense(jfn, {"b": np.zeros(4)}, data, "mean")
