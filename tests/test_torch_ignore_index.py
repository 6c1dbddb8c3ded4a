"""Padded batches (cross-entropy's ``ignore_index``) in KFAC and the GGN
diagonal, against the JAX package, on the CPU.

Twins of the padded-KFAC and padded-diagonal tests of
``tests/test_ignore_index.py``: a two-layer sequence model whose last
position of every example carries the target -100. Ignored rows contribute
nothing and the mean divides by the targets that count, so KFAC's gradient
covariances on the padded batch equal those of the batch with that position
dropped (type-2 and empirical, mean and sum, JAX's tolerances rtol 1e-5,
atol 1e-7), the type-2 GGN diagonal equals the dense GGN's diagonal (rtol
1e-4, atol 1e-6), and MC and type-2 KFAC stay finite. The same numpy weights
and data go through the JAX package, whose operators are the oracles of the
deterministic builds (relative Frobenius 1e-5, float32). Every JAX oracle
is one ``jax.jit`` call.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

import curvlinops_tpu as cl
import curvlinops_tpu_torch as T
from curvlinops_tpu.losses import CrossEntropyLoss as JCE
from curvlinops_tpu_torch.losses import CrossEntropyLoss
from curvlinops_tpu_torch.models.common import from_jax_params
from tests.test_torch_helpers import capped_torch_threads, port_order, rel_fro

_threads = capped_torch_threads()

JAX_TOL = 1e-5  # float32, the port against the JAX package (summation order)

_RNG = np.random.default_rng(0)
W = (0.4 * _RNG.standard_normal((5, 8))).astype(np.float32)
V = (0.4 * _RNG.standard_normal((8, 4))).astype(np.float32)
X = _RNG.standard_normal((3, 4, 5)).astype(np.float32)
Y = _RNG.integers(0, 4, (3, 4))
Y[:, -1] = -100  # ignore the last position of every example (uniform padding)
JTREE = {"l0": {"W": W}, "l1": {"W": V}}


class _SeqModel(nn.Module):
    """``tanh(x W) V`` at every position of ``[B, T, 5]``: logits as
    ``[(B T), 4]`` rows, the rows without the last position (``truncate``),
    or ``[B, 4, T]`` (``channels``, cross-entropy's ``[N, C, D]`` layout)."""

    def __init__(self, out: str = "rows"):
        super().__init__()
        self.l0 = nn.Linear(5, 8, bias=False)
        self.l1 = nn.Linear(8, 4, bias=False)
        self.out = out
        self.load_state_dict(from_jax_params(JTREE, self))

    def forward(self, x):  # noqa: D102
        h = self.l1(torch.tanh(self.l0(x)))
        if self.out == "channels":
            return h.movedim(-1, 1)
        if self.out == "truncate":
            h = h[:, :-1]
        return h.reshape(-1, 4)


def _jax_model(out: str = "rows"):
    def model_fn(p, x):
        h = jnp.tanh(x @ p["l0"]["W"]) @ p["l1"]["W"]
        if out == "channels":
            return jnp.moveaxis(h, -1, 1)
        if out == "truncate":
            h = h[:, :-1]
        return h.reshape(-1, 4)

    return model_fn


def _data(out: str = "rows"):
    """``(torch data, JAX data)``: the padded targets, flat or ``[N, D]``
    (``channels``), or the truncated ones."""
    y = Y if out == "channels" else (Y[:, :-1] if out == "truncate" else Y).reshape(-1)
    return ([(torch.from_numpy(X), torch.from_numpy(y))],
            [(jnp.asarray(X), jnp.asarray(y))])


def _port_kfac(out: str, reduction: str, fisher_type: str, **kw):
    model = _SeqModel(out)
    return T.KFACLinearOperator(model, CrossEntropyLoss(reduction), dict(model.named_parameters()),
                                _data(out)[0], fisher_type=fisher_type,
                                check_deterministic=False, **kw)


def _jax_dense(op, model) -> np.ndarray:
    """A JAX operator's dense matrix in the port's parameter order."""
    jparams = jax.tree.map(jnp.asarray, JTREE)
    dense = np.asarray(jax.jit(lambda e: op @ e)(jnp.eye(op.shape[1], dtype=jnp.float32)))
    perm = port_order(jparams, model, [n for n, _ in model.named_parameters()]).numpy()
    return dense[perm][:, perm]


def _jax_kfac(reduction: str, fisher_type: str):
    return cl.KFACLinearOperator(_jax_model(), JCE(reduction), jax.tree.map(jnp.asarray, JTREE),
                                 _data()[1], fisher_type=fisher_type, check_deterministic=False)


def _assert_ggt_equal(pad, trunc):
    assert set(pad._ggT) == set(trunc._ggT)
    for gi in pad._ggT:
        np.testing.assert_allclose(pad._ggT[gi].numpy(), trunc._ggT[gi].numpy(),
                                   rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("reduction", ["mean", "sum"])
def test_padded_kfac_ggt_equals_truncated(reduction):
    """Type-2 KFAC: the padded batch's gradient covariances equal the
    truncated batch's (the input covariances legitimately differ: they see
    the padded positions' activations); the padded operator equals JAX's."""
    pad = _port_kfac("rows", reduction, "type-2")
    _assert_ggt_equal(pad, _port_kfac("truncate", reduction, "type-2"))
    dense = pad @ torch.eye(pad.shape[1])
    assert rel_fro(dense, _jax_dense(_jax_kfac(reduction, "type-2"), _SeqModel())) < JAX_TOL


def test_padded_ggn_diagonal_equals_dense_diagonal():
    """The type-2 GGN diagonal on the padded batch in cross-entropy's
    ``[N, C, D]`` layout equals the dense GGN's diagonal (rtol 1e-4, atol
    1e-6), and JAX's diagonal (1e-5)."""
    model = _SeqModel("channels")
    params, (data, jdata) = dict(model.named_parameters()), _data("channels")
    G = T.GGNLinearOperator(model, CrossEntropyLoss("mean"), params, data,
                            check_deterministic=False)
    diag = T.GGNDiagonalLinearOperator(model, CrossEntropyLoss("mean"), params, data,
                                       check_deterministic=False)
    flat = torch.cat([diag.diagonal[n].reshape(-1) for n in params])
    np.testing.assert_allclose(flat.numpy(), torch.diagonal(G @ torch.eye(G.shape[1])).numpy(),
                               rtol=1e-4, atol=1e-6)
    jdiag = cl.GGNDiagonalLinearOperator(_jax_model("channels"), JCE("mean"),
                                         jax.tree.map(jnp.asarray, JTREE), jdata,
                                         check_deterministic=False)
    expected = from_jax_params(jax.tree.map(np.asarray, jdiag.diagonal), model)
    assert rel_fro(flat, torch.cat([expected[n].reshape(-1) for n in params])) < JAX_TOL


def test_kfac_builds_on_padded_batch():
    """Type-2 and MC (two samples) KFAC on padded targets, sum: finite
    matvecs (no NaN from the -100 lookup); the type-2 operator equals
    JAX's."""
    v = torch.from_numpy(np.random.default_rng(0).standard_normal(72).astype(np.float32))
    for fisher_type in ("type-2", "mc"):
        kfac = _port_kfac("rows", "sum", fisher_type, mc_samples=2 if fisher_type == "mc" else 1)
        assert bool(torch.isfinite(kfac @ v).all()), fisher_type
        if fisher_type == "type-2":
            dense = kfac @ torch.eye(72)
            assert rel_fro(dense, _jax_dense(_jax_kfac("sum", "type-2"), _SeqModel())) < JAX_TOL


def test_padded_kfac_empirical_ggt_equals_truncated():
    """The empirical Fisher's normalisation counts the targets that count,
    so the mean rescale applies to it too: padded equals truncated, and the
    padded operator equals JAX's."""
    pad = _port_kfac("rows", "mean", "empirical")
    _assert_ggt_equal(pad, _port_kfac("truncate", "mean", "empirical"))
    dense = pad @ torch.eye(pad.shape[1])
    assert rel_fro(dense, _jax_dense(_jax_kfac("mean", "empirical"), _SeqModel())) < JAX_TOL
