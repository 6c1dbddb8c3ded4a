"""The widened case matrix, against the JAX package, on the CPU.

Twins of ``tests/test_case_matrix.py`` (all but ``test_shard_params_report``,
whose twin is in ``tests/test_torch_parallel.py``):

- a UNet-style conv model whose layers see different numbers of spatial
  locations (a stride-2 conv, a conv, nearest upsampling, a conv), on two
  ragged batches: KFAC with the sum reduction, scaled by the loss terms,
  equals KFAC with the mean (MSE, cross-entropy and BCE; type-2, MC and
  empirical; JAX's rtol 5e-4, atol 1e-7), and the type-2 builds equal the
  JAX package's (relative Frobenius 1e-5); REDUCE builds and is
  symmetric PSD;
- the non-determinism refusals: dropout-like masks in the data pipeline,
  batch statistics over reshuffled batches and a batch dropped at random
  each pass raise at construction; batch statistics in a fixed order pass
  and equal the JAX package's GGN;
- ragged batches (4, 4, 3) for the Hessian, the GGN and the empirical
  Fisher against dense oracles, and the GGN diagonal against the dense
  GGN's (JAX's rtol 5e-4, atol 1e-5). The oracles are those of
  ``curvlinops_tpu/examples.py`` (``dense_hessian``, ``dense_ggn``,
  ``dense_empirical_fisher``) for cross-entropy with the mean, written as one
  ``jax.jit`` program: op by op they compile for about 10 s.

MSE and BCE read the last axis as the feature axis in both packages, so the
port's UNet emits its NCHW output channels-last, as the JAX model's NHWC
output is; type-2 KFAC on an ``[N, C, H, W]`` output would differ from the
block-diagonal GGN by 100 %. The same numpy weights and data go through
both packages; every JAX operator oracle is one ``jax.jit`` call.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree
from torch import nn

import curvlinops_tpu as cl
import curvlinops_tpu_torch as T
from curvlinops_tpu.kfac.operator import KFACLinearOperator as JKFAC
from curvlinops_tpu.losses import BCEWithLogitsLoss as JBCE
from curvlinops_tpu.losses import CrossEntropyLoss as JCE
from curvlinops_tpu.losses import MSELoss as JMSE
from curvlinops_tpu_torch.losses import BCEWithLogitsLoss, CrossEntropyLoss, MSELoss
from curvlinops_tpu_torch.models.common import from_jax_params
from tests.test_torch_helpers import capped_torch_threads, port_order, rel_fro

_threads = capped_torch_threads()

JAX_TOL = 1e-5  # float32, the port against the JAX package (summation order)
S = 6  # the UNet's image size: 36 locations, 9 at the bottleneck
LOSSES = {"mse": (MSELoss, JMSE), "ce": (CrossEntropyLoss, JCE), "bce": (BCEWithLogitsLoss, JBCE)}


# ---------------------------------------------------------------------- #
# UNet-style conv weight sharing
# ---------------------------------------------------------------------- #
def _unet_tree(seed: int) -> dict:
    rng = np.random.default_rng(seed)

    def conv(cin, cout):
        return {"W": (0.4 * rng.standard_normal((3, 3, cin, cout))).astype(np.float32),
                "b": (0.1 * rng.standard_normal(cout)).astype(np.float32)}

    return {"c1": conv(3, 2), "c2": conv(2, 2), "c3": conv(2, 3)}


class _UNet(nn.Module):
    """Conv (stride 2) -> conv -> nearest upsampling x2 -> conv on NCHW
    images; the output channels-last ``[B, S, S, C]`` (MSE, BCE) or as
    ``[(B S S), C]`` rows (cross-entropy), as the JAX model's NHWC output."""

    def __init__(self, tree: dict, loss_kind: str):
        super().__init__()
        self.c1 = nn.Conv2d(3, 2, 3, stride=2, padding=1)
        self.c2 = nn.Conv2d(2, 2, 3, padding=1)
        self.c3 = nn.Conv2d(2, 3, 3, padding=1)
        self.loss_kind = loss_kind
        self.load_state_dict(from_jax_params(tree, self))

    def forward(self, x):  # noqa: D102
        h = self.c2(self.c1(x))
        h = self.c3(h.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3))
        h = h.permute(0, 2, 3, 1)
        return h.reshape(-1, h.shape[-1]) if self.loss_kind == "ce" else h


def _jax_unet(loss_kind: str):
    def conv(x, p, stride):
        out = jax.lax.conv_general_dilated(x, p["W"], (stride, stride), [(1, 1), (1, 1)],
                                           dimension_numbers=("NHWC", "HWIO", "NHWC"))
        return out + p["b"]

    def fn(params, X):
        h = conv(conv(X, params["c1"], 2), params["c2"], 1)
        h = conv(jnp.repeat(jnp.repeat(h, 2, axis=1), 2, axis=2), params["c3"], 1)
        return h.reshape(-1, h.shape[-1]) if loss_kind == "ce" else h

    return fn


def _unet_data(loss_kind: str, seed: int):
    """Two ragged batches (2 and 4 images): ``(torch data, JAX data)``."""
    rng = np.random.default_rng(seed)
    tdata, jdata = [], []
    for B in (2, 4):
        X = rng.standard_normal((B, S, S, 3)).astype(np.float32)
        if loss_kind == "mse":
            y = rng.standard_normal((B, S, S, 3)).astype(np.float32)
        elif loss_kind == "bce":
            y = (rng.uniform(size=(B, S, S, 3)) < 0.5).astype(np.float32)
        else:
            y = rng.integers(0, 3, B * S * S)
        tdata.append((torch.from_numpy(X).permute(0, 3, 1, 2).contiguous(), torch.from_numpy(y)))
        jdata.append((jnp.asarray(X), jnp.asarray(y)))
    return tdata, jdata


def _dense(op, n: int) -> np.ndarray:
    return (op @ torch.eye(n)).numpy()


def _jax_dense(op, jparams, model) -> np.ndarray:
    """A JAX operator's dense matrix in the port's parameter order."""
    dense = np.asarray(jax.jit(lambda e: op @ e)(jnp.eye(op.shape[1], dtype=jnp.float32)))
    perm = port_order(jparams, model, [n for n, _ in model.named_parameters()]).numpy()
    return dense[perm][:, perm]


@pytest.mark.parametrize("fisher_type", ["type-2", "mc", "empirical"])
@pytest.mark.parametrize("loss_kind", ["mse", "ce", "bce"])
def test_unet_expand_sum_vs_mean_scaling(loss_kind, fisher_type):
    """KFAC(mean) equals KFAC(sum) with ``ggT`` scaled by ``1 / (N x loss
    terms per datum)``: S^2 locations, times 3 channels for MSE and BCE,
    which average over them too (rtol 5e-4, atol 1e-7). The layers see S^2
    and S^2 / 4 locations, so a mis-scaled EXPAND shows. The type-2 build
    equals the JAX package's (its MC draws differ)."""
    tree = _unet_tree(0)
    model = _UNet(tree, loss_kind)
    params = dict(model.named_parameters())
    data, jdata = _unet_data(loss_kind, 1)
    loss_cls, jloss_cls = LOSSES[loss_kind]
    kw = dict(fisher_type=fisher_type, check_deterministic=False, seed=7)
    kfac_sum = T.KFACLinearOperator(model, loss_cls("sum"), params, data, **kw)
    kfac_mean = T.KFACLinearOperator(model, loss_cls("mean"), params, data, **kw)
    terms = S * S * (3 if loss_kind in ("mse", "bce") else 1)
    scale = 1.0 / (sum(X.shape[0] for X, _ in data) * terms)
    n = kfac_sum.shape[1]
    dense_mean = _dense(kfac_mean, n)
    np.testing.assert_allclose(scale * _dense(kfac_sum, n), dense_mean, rtol=5e-4, atol=1e-7,
                               err_msg=f"unet {loss_kind} {fisher_type} sum-vs-mean scaling")
    if fisher_type == "type-2":
        jparams = jax.tree.map(jnp.asarray, tree)
        J = JKFAC(_jax_unet(loss_kind), jloss_cls("mean"), jparams, jdata, use_pallas=False,
                  **kw)
        assert rel_fro(dense_mean, _jax_dense(J, jparams, model)) < JAX_TOL


def test_unet_reduce_builds_and_is_psd():
    """REDUCE (averaged patches), MSE, MC with two samples: the dense KFAC
    is symmetric (atol 1e-6) and its eigenvalues above -1e-6."""
    model = _UNet(_unet_tree(3), "mse")
    data, _ = _unet_data("mse", 4)
    kfac = T.KFACLinearOperator(model, MSELoss("mean"), dict(model.named_parameters()), data,
                                kfac_approx="reduce", fisher_type="mc", mc_samples=2,
                                check_deterministic=False)
    dense = _dense(kfac, kfac.shape[1]).astype(np.float64)
    np.testing.assert_allclose(dense, dense.T, atol=1e-6)
    assert np.linalg.eigvalsh(dense).min() > -1e-6


# ---------------------------------------------------------------------- #
# the non-determinism refusal family
# ---------------------------------------------------------------------- #
def _mlp_tree(seed: int, D=6, H=5, C=3) -> dict:
    rng = np.random.default_rng(seed)
    return {"l0": {"W": (0.5 * rng.standard_normal((D, H))).astype(np.float32)},
            "l1": {"W": (0.5 * rng.standard_normal((H, C))).astype(np.float32)}}


class _MLP(nn.Module):
    """``relu(X w1) w2``, or with batch statistics between (``batchstat``:
    the loss then depends on how the data is batched)."""

    def __init__(self, tree: dict, batchstat: bool = False):
        super().__init__()
        D, H = tree["l0"]["W"].shape
        self.l0 = nn.Linear(D, H, bias=False)
        self.l1 = nn.Linear(H, tree["l1"]["W"].shape[1], bias=False)
        self.batchstat = batchstat
        self.load_state_dict(from_jax_params(tree, self))

    def forward(self, x):  # noqa: D102
        h = self.l0(x)
        if self.batchstat:
            h = (h - h.mean(0)) / (h.std(0, unbiased=False) + 1e-5)
        return self.l1(torch.relu(h))


def _jax_batchstat(p, X):
    h = X @ p["l0"]["W"]
    h = (h - h.mean(axis=0)) / (h.std(axis=0) + 1e-5)
    return jax.nn.relu(h) @ p["l1"]["W"]


def _simple_data(seed: int, N=12, D=6, C=3, batches=4) -> list:
    rng = np.random.default_rng(seed)
    X = torch.from_numpy(rng.standard_normal((N, D)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, C, N))
    return list(zip(X.chunk(batches), y.chunk(batches)))


class _DropoutAugmentedData:
    """A fresh Bernoulli input mask each pass (dropout in the pipeline)."""

    def __init__(self, data):
        self._data, self._gen = data, torch.Generator().manual_seed(0)

    def __iter__(self):
        return iter([(X * (torch.rand(X.shape, generator=self._gen) < 0.5), y)
                     for X, y in self._data])


class _ShuffledData:
    """The examples reshuffled into new batches each pass
    (``DataLoader(shuffle=True)``)."""

    def __init__(self, data):
        self._X = torch.cat([X for X, _ in data])
        self._y = torch.cat([y for _, y in data])
        self._n, self._gen = len(data), torch.Generator().manual_seed(0)

    def __iter__(self):
        order = torch.randperm(self._X.shape[0], generator=self._gen)
        return iter(list(zip(self._X[order].chunk(self._n), self._y[order].chunk(self._n))))


class _RandomDropData:
    """A different batch dropped each pass (drop_last with shuffling)."""

    def __init__(self, data):
        self._data, self._count = data, 0

    def __iter__(self):
        drop = self._count % len(self._data)
        self._count += 1
        return iter([b for i, b in enumerate(self._data) if i != drop])


def _params(model) -> dict:
    return dict(model.named_parameters())


def test_dropout_like_pipeline_refused():
    """Per-pass dropout masks in the input pipeline are caught."""
    model = _MLP(_mlp_tree(0))
    with pytest.raises(RuntimeError, match="deterministic"):
        T.GGNLinearOperator(model, CrossEntropyLoss("mean"), _params(model),
                            _DropoutAugmentedData(_simple_data(1)))


def test_batchstat_with_shuffled_batches_refused():
    """Batch statistics over batches reshuffled each pass are caught."""
    model = _MLP(_mlp_tree(2), batchstat=True)
    with pytest.raises(RuntimeError, match="deterministic"):
        T.GGNLinearOperator(model, CrossEntropyLoss("mean"), _params(model),
                            _ShuffledData(_simple_data(3)))


def test_batchstat_with_fixed_order_passes():
    """The positive control: batch statistics in a fixed order build (with
    the determinism probe) and the matvec equals the JAX package's GGN."""
    tree = _mlp_tree(2)
    model = _MLP(tree, batchstat=True)
    data = _simple_data(3)
    op = T.GGNLinearOperator(model, CrossEntropyLoss("mean"), _params(model), data)
    v = torch.from_numpy(np.random.default_rng(0).normal(size=op.shape[1]).astype(np.float32))
    assert bool(torch.isfinite(op @ v).all())
    jparams = jax.tree.map(jnp.asarray, tree)
    J = cl.GGNLinearOperator(_jax_batchstat, JCE("mean"), jparams,
                             [(jnp.asarray(X.numpy()), jnp.asarray(y.numpy())) for X, y in data],
                             check_deterministic=False)
    assert rel_fro(_dense(op, op.shape[1]), _jax_dense(J, jparams, model)) < JAX_TOL


def test_random_batch_drop_refused():
    """A batch dropped at random each pass is caught (Hessian)."""
    model = _MLP(_mlp_tree(4))
    with pytest.raises(RuntimeError, match="deterministic"):
        T.HessianLinearOperator(model, CrossEntropyLoss("mean"), _params(model),
                                _RandomDropData(_simple_data(5)))


# ---------------------------------------------------------------------- #
# ragged (drop_last-style, non-divisible) batches for every operator
# ---------------------------------------------------------------------- #
def _ragged_case(seed: int, sizes=(4, 4, 3), D=5, C=3):
    """``(tree, torch model, torch data, JAX data)``: 11 data in ragged
    batches."""
    tree = _mlp_tree(seed, D=D, C=C)
    rng = np.random.default_rng(seed + 10)
    X = rng.standard_normal((sum(sizes), D)).astype(np.float32)
    y = rng.integers(0, C, sum(sizes))
    bounds = np.cumsum((0,) + sizes)
    parts = [(X[a:b], y[a:b]) for a, b in zip(bounds[:-1], bounds[1:])]
    return (tree, _MLP(tree), [(torch.from_numpy(a), torch.from_numpy(b)) for a, b in parts],
            [(jnp.asarray(a), jnp.asarray(b)) for a, b in parts])


def _jax_relu_mlp(p, X):
    return jax.nn.relu(X @ p["l0"]["W"]) @ p["l1"]["W"]


def _dense_oracles(tree: dict, jdata: list) -> dict:
    """The dense Hessian, GGN and empirical Fisher of the mean cross-entropy
    over all batches, in one ``jax.jit`` program: ``jax.hessian`` of the
    risk; per batch ``(n_b / N) J^T H_loss J`` summed; one gradient row per
    datum, ``J^T J / N``."""
    flat, unravel = ravel_pytree(jax.tree.map(jnp.asarray, tree))
    N = sum(X.shape[0] for X, _ in jdata)
    loss = JCE("mean")

    def per_datum(v, X, y):
        logits = _jax_relu_mlp(unravel(v), X)
        return -jnp.take_along_axis(jax.nn.log_softmax(logits), y[:, None], axis=1)[:, 0]

    def oracles(v):
        H = jax.hessian(lambda u: sum(per_datum(u, X, y).sum() for X, y in jdata) / N)(v)
        G = sum(X.shape[0] / N * (lambda J, Hl: J.T @ Hl @ J)(
            jax.jacobian(lambda u: _jax_relu_mlp(unravel(u), X).reshape(-1))(v),
            jax.hessian(lambda f: loss(f.reshape(X.shape[0], -1), y))(
                _jax_relu_mlp(unravel(v), X).reshape(-1)))
            for X, y in jdata)
        rows = jnp.concatenate([jax.jacobian(per_datum)(v, X, y) for X, y in jdata])
        return {"hessian": H, "ggn": G, "ef": rows.T @ rows / N}

    return jax.tree.map(np.asarray, jax.jit(oracles)(flat))


def _in_port_order(dense: np.ndarray, tree: dict, model) -> np.ndarray:
    perm = port_order(jax.tree.map(jnp.asarray, tree), model,
                      [n for n, _ in model.named_parameters()]).numpy()
    return dense[perm][:, perm]


RAGGED = {"hessian": T.HessianLinearOperator, "ggn": T.GGNLinearOperator,
          "ef": T.EFLinearOperator}


@pytest.fixture(scope="module")
def ragged():
    """Two ragged cases (seeds 6 and 7) with their dense oracles."""
    out = {}
    for seed in (6, 7):
        tree, model, data, jdata = _ragged_case(seed)
        dense = {k: _in_port_order(d, tree, model) for k, d in _dense_oracles(tree, jdata).items()}
        out[seed] = (model, data, dense)
    return out


@pytest.mark.parametrize("op", sorted(RAGGED))
def test_ragged_batches_match_dense_oracle(ragged, op):
    """Batches of 4, 4 and 3 (mean reduction): each operator's dense matrix
    against its dense oracle (rtol 5e-4, atol 1e-5)."""
    model, data, dense = ragged[6]
    A = RAGGED[op](model, CrossEntropyLoss("mean"), _params(model), data)
    np.testing.assert_allclose(_dense(A, A.shape[1]), dense[op], rtol=5e-4, atol=1e-5)


def test_ragged_batches_ggn_diagonal(ragged):
    """The GGN diagonal on ragged batches against the dense GGN's diagonal
    (rtol 5e-4, atol 1e-5)."""
    model, data, dense = ragged[7]
    params = _params(model)
    diag = T.GGNDiagonalLinearOperator(model, CrossEntropyLoss("mean"), params, data)
    flat = torch.cat([diag.diagonal[n].reshape(-1) for n in params]).numpy()
    np.testing.assert_allclose(flat, np.diag(dense["ggn"]), rtol=5e-4, atol=1e-5)
