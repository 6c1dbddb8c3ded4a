"""KFAC for ``torch.cond``-gated layers, and the collector's conv coverage.

Twins of ``tests/test_kfac_cond.py``: a layer inside a ``torch.cond``
branch contributes its normal Kronecker factors when the branch is taken and
an exactly-zero block when it is not (the collector lowers the cond to a
select, as the JAX collector lowers ``lax.cond``); ties across branches,
embeddings and bias-only blocks in branches, parameter-derived predicates,
parameters flowing out and cond/scan nesting are refused with a message
naming ``cond``. The same numpy inputs go through the JAX ``lax.cond`` model
and the port's ``torch.cond`` model, with JAX's tolerances. Besides: the
port's GGN, Hessian and GGN diagonal on a cond model against JAX's
(``utils/cond.py`` inlines the cond under ``torch.func``; the diagonal maps a
per-datum predicate under ``vmap``), and grouped, dilated, 1-D and
function-level convs in JAX's layouts against JAX's KFAC at EXPAND and
REDUCE. No test calls torch's eager ``torch.cond`` (a dynamo compile each).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn

from curvlinops_tpu import EKFACLinearOperator as JEKFAC
from curvlinops_tpu import FisherType as JFisherType
from curvlinops_tpu import GGNDiagonalLinearOperator as JGGNDiagonal
from curvlinops_tpu import GGNLinearOperator as JGGN
from curvlinops_tpu import HessianLinearOperator as JHessian
from curvlinops_tpu import KFACLinearOperator as JKFAC
from curvlinops_tpu import KFACType as JKFACType
from curvlinops_tpu import MSELoss as JMSELoss
from curvlinops_tpu_torch import (
    EKFACLinearOperator,
    GGNDiagonalLinearOperator,
    GGNLinearOperator,
    HessianLinearOperator,
    KFACLinearOperator,
    MSELoss,
)
from curvlinops_tpu_torch.models.stack import scan
from tests.test_kfac_cond import _gated_linear_fn
from tests.test_torch_helpers import (
    assert_close,
    blockdiag_ggn,
    capped_torch_threads,
    dense_of,
    port_order,
)

_threads = capped_torch_threads()

SIZES, N = (4, 3, 2), 8
TAKEN, UNTAKEN = -1e9, 1e9  # thresholds of the gate: always / never taken


def _np_case(seed=0):
    rng = np.random.default_rng(seed)
    params = {
        f"layer{i}": {
            "W": (0.5 * rng.standard_normal((a, b))).astype(np.float32),
            "b": (0.1 * rng.standard_normal(b)).astype(np.float32),
        }
        for i, (a, b) in enumerate(zip(SIZES[:-1], SIZES[1:]))
    }
    X = rng.standard_normal((N, SIZES[0])).astype(np.float32)
    y = rng.standard_normal((N, SIZES[-1])).astype(np.float32)
    return params, X, y


class Dense(nn.Module):
    """JAX's ``x @ W + b`` with the JAX leaf layout ``W [in, out]``."""

    def __init__(self, W, b=None):
        super().__init__()
        self.weight = nn.Parameter(torch.tensor(W))
        self.bias = None if b is None else nn.Parameter(torch.tensor(b))

    def forward(self, x):  # noqa: D102
        h = x @ self.weight
        return h if self.bias is None else h + self.bias


class GatedLinear(nn.Module):
    """``_gated_linear_fn``: the middle layer gated on a data statistic."""

    def __init__(self, params, threshold=None):
        super().__init__()
        self.layer0 = Dense(params["layer0"]["W"], params["layer0"]["b"])
        self.layer1 = Dense(params["layer1"]["W"], params["layer1"]["b"])
        self.threshold = threshold  # None: the plain, ungated model

    def forward(self, x):  # noqa: D102
        x = self.layer0(x)
        if self.threshold is None:
            return self.layer1(x)
        return torch.cond(
            x.sum() > self.threshold, self.layer1,
            lambda h: h.new_zeros(h.shape[:-1] + (self.layer1.weight.shape[1],)), (x,),
        )


def _kfac(model, data, **kw):
    kw.setdefault("check_deterministic", False)
    return KFACLinearOperator(model, MSELoss("mean"), dict(model.named_parameters()), data,
                              fisher_type="type-2", **kw)


@functools.cache
def _jax_kfac_gated(threshold) -> np.ndarray:
    params, X, y = _np_case()
    k = JKFAC(_gated_linear_fn(threshold), JMSELoss("mean"), params, [(X, y)],
              fisher_type=JFisherType.TYPE2, check_deterministic=False)
    return np.asarray(k.todense())


def _gated(threshold):
    params, X, y = _np_case()
    model = GatedLinear(params, threshold)
    return model, [(torch.tensor(X), torch.tensor(y))]


def test_cond_taken_branch_exact_deep_linear():
    """Predicate true for the data: KFAC == block-diagonal GGN exactly, and
    == JAX's KFAC of the ``lax.cond`` model."""
    model, data = _gated(TAKEN)
    kfac = _kfac(model, data, check_deterministic=True)
    dense = dense_of(kfac)
    expected = blockdiag_ggn(model, MSELoss("mean"), dict(model.named_parameters()), data,
                             kfac.groups)
    assert_close(dense, expected, rtol=5e-4, atol=1e-5, name="kfac vs ggn")
    assert_close(dense, _jax_kfac_gated(TAKEN), rtol=5e-4, atol=1e-5, name="kfac vs JAX")
    assert [u.cond_branch for g in kfac.groups for u in g.uses if g.weight_path] == [None, 1]


def test_cond_taken_matches_plain_model():
    """With the gate always taken, factors equal the ungated model's."""
    model, data = _gated(TAKEN)
    plain, _ = _gated(None)
    assert_close(dense_of(_kfac(model, data)), dense_of(_kfac(plain, data)),
                 rtol=1e-5, atol=1e-6, name="gated vs plain")


def test_cond_untaken_branch_zero_block():
    """Predicate false: the gated layer's block is exactly zero, its input
    covariance too, and every other block matches the dense GGN."""
    model, data = _gated(UNTAKEN)
    kfac = _kfac(model, data)
    dense = dense_of(kfac)
    n0 = sum(p.numel() for p in model.layer0.parameters())
    assert dense[n0:].abs().max().item() == 0.0
    assert dense[:, n0:].abs().max().item() == 0.0
    gated = [gi for gi, g in enumerate(kfac.groups) if (g.weight_path or "").startswith("layer1")]
    assert gated and all(kfac._aaT[gi].abs().max().item() == 0.0 for gi in gated)
    expected = blockdiag_ggn(model, MSELoss("mean"), dict(model.named_parameters()), data,
                             kfac.groups)
    assert_close(dense, expected, rtol=5e-4, atol=1e-5, name="kfac vs ggn")
    assert_close(dense, _jax_kfac_gated(UNTAKEN), rtol=5e-4, atol=1e-5, name="kfac vs JAX")


def _branches_case():
    rng = np.random.default_rng(5)
    Wa, Wb = (0.5 * rng.standard_normal((2, 4, 2))).astype(np.float32)
    X = rng.standard_normal((6, 4)).astype(np.float32)
    y = rng.standard_normal((6, 2)).astype(np.float32)
    return {"Wa": Wa, "Wb": Wb}, X, y


class Branches(nn.Module):
    """Different weights per branch (``act`` on branch a's output)."""

    def __init__(self, params, act=None):
        super().__init__()
        self.Wa = nn.Parameter(torch.tensor(params["Wa"]))
        self.Wb = nn.Parameter(torch.tensor(params["Wb"]))
        self.act = act

    def forward(self, x):  # noqa: D102
        a = (lambda h: self.act(h @ self.Wa)) if self.act else (lambda h: h @ self.Wa)
        return torch.cond(x.sum() > -1e9, a, lambda h: h @ self.Wb, (x,))


def _jax_branches(act=None):
    def fn(p, x):
        def a(h):
            out = h @ p["Wa"]
            return act(out) if act else out

        return jax.lax.cond(jnp.sum(x) > -1e9, a, lambda h: h @ p["Wb"], x)

    return fn


def test_cond_both_branches_distinct_weights():
    """Different weights per branch: each gets gated factors, the sum is
    exact, the untaken branch's block is 0.0, and JAX's KFAC agrees."""
    params, X, y = _branches_case()
    model = Branches(params)
    data = [(torch.tensor(X), torch.tensor(y))]
    kfac = _kfac(model, data)
    dense = dense_of(kfac)
    expected = blockdiag_ggn(model, MSELoss("mean"), dict(model.named_parameters()), data,
                             kfac.groups)
    assert_close(dense, expected, rtol=5e-4, atol=1e-5, name="kfac vs ggn")
    assert dense[8:].abs().max().item() == 0.0  # Wb: the untaken branch
    jk = JKFAC(_jax_branches(), JMSELoss("mean"), params, [(X, y)],
               fisher_type=JFisherType.TYPE2, check_deterministic=False)
    assert_close(dense, np.asarray(jk.todense()), rtol=5e-4, atol=1e-5, name="kfac vs JAX")


# --------------------------------------------------------------------- #
# refusals: both packages refuse, the port's message names cond
# --------------------------------------------------------------------- #
class _Tied(nn.Module):
    def __init__(self):
        super().__init__()
        self.W = nn.Parameter(torch.ones(3, 3))

    def forward(self, x):  # noqa: D102
        return torch.cond(x.sum() > 0, lambda h: h @ self.W, lambda h: 2.0 * (h @ self.W), (x,))


class _ParamPredicate(nn.Module):
    def __init__(self):
        super().__init__()
        self.W = nn.Parameter(torch.ones(3, 3))

    def forward(self, x):  # noqa: D102
        return torch.cond(self.W.sum() > 0, lambda h: 2.0 * h, lambda h: 3.0 * h, (x @ self.W,))


class _FlowsOut(nn.Module):
    def __init__(self):
        super().__init__()
        self.W = nn.Parameter(torch.ones(3, 3))

    def forward(self, x):  # noqa: D102
        W = torch.cond(x.sum() > 0, lambda w: w, lambda w: 2.0 * w, (self.W,))
        return x @ W


class _InsideScan(nn.Module):
    def __init__(self):
        super().__init__()
        self.W = nn.Parameter(torch.ones(3, 3))

    def forward(self, x):  # noqa: D102
        def body(h, _):
            return torch.cond(h.sum() > 0, lambda v: v @ self.W, lambda v: v, (h,))

        return scan(body, x, 2)


class _ScanInBranch(nn.Module):
    def __init__(self):
        super().__init__()
        self.W = nn.Parameter(torch.ones(3, 3))

    def forward(self, x):  # noqa: D102
        def branch(h):
            return scan(lambda c, _: c @ self.W, h, 2)

        return torch.cond(x.sum() > 0, branch, lambda h: h, (x,))


class _Embedding(nn.Module):
    def __init__(self):
        super().__init__()
        self.E = nn.Embedding(5, 3, _weight=torch.ones(5, 3))

    def forward(self, idx):  # noqa: D102
        return torch.cond(
            idx.sum() > 0, lambda i: self.E(i).reshape(i.shape[0], -1),
            lambda i: torch.zeros(i.shape[0], 3), (idx,),
        )


def _jax_refusals():
    W3 = {"W": jnp.ones((3, 3))}

    def tied(p, x):
        return jax.lax.cond(jnp.sum(x) > 0, lambda h: h @ p["W"], lambda h: 2.0 * (h @ p["W"]), x)

    def predicate(p, x):
        return jax.lax.cond(jnp.sum(p["W"]) > 0, lambda h: 2.0 * h, lambda h: 3.0 * h, x @ p["W"])

    def flows_out(p, x):
        return x @ jax.lax.cond(jnp.sum(x) > 0, lambda w: w, lambda w: 2.0 * w, p["W"])

    def inside_scan(p, x):
        def body(h, _):
            return jax.lax.cond(jnp.sum(h) > 0, lambda v: v @ p["W"], lambda v: v, h), None

        return jax.lax.scan(body, x, None, length=2)[0]

    def scan_in_branch(p, x):
        def branch(h):
            return jax.lax.scan(lambda c, _: (c @ p["W"], None), h, None, length=2)[0]

        return jax.lax.cond(jnp.sum(x) > 0, branch, lambda h: h, x)

    def embedding(p, idx):
        return jax.lax.cond(jnp.sum(idx) > 0, lambda i: p["E"][i].reshape(i.shape[0], -1),
                            lambda i: jnp.zeros((i.shape[0], 3)), idx)

    xs = (jnp.ones((2, 3)), jnp.ones((2, 3)))
    return {
        "tied": (tied, W3, xs), "predicate": (predicate, W3, xs),
        "flows_out": (flows_out, W3, xs), "inside_scan": (inside_scan, W3, xs),
        "scan_in_branch": (scan_in_branch, W3, xs),
        "embedding": (embedding, {"E": jnp.ones((5, 3))}, (jnp.array([1, 2]), jnp.ones((2, 3)))),
    }


REFUSALS = {  # JAX's match= patterns
    "tied": (_Tied, "cond"),
    "predicate": (_ParamPredicate, "cond|unsupported"),
    "flows_out": (_FlowsOut, "cond"),
    "inside_scan": (_InsideScan, "cond|scan"),
    "scan_in_branch": (_ScanInBranch, "cond|scan"),
    "embedding": (_Embedding, "cond|embedding|unsupported"),
}


def _refusal_test(case):
    cls, match = REFUSALS[case]
    fn, jparams, (jX, jy) = _jax_refusals()[case]
    with pytest.raises(ValueError, match=match):
        JKFAC(fn, JMSELoss("mean"), jparams, [(jX, jy)], check_deterministic=False)
    model = cls()
    X = torch.tensor(np.asarray(jX))
    with pytest.raises(ValueError, match=match) as info:
        _kfac(model, [(X, torch.ones(2, 3))])
    assert "cond" in str(info.value)


def test_cond_tied_across_branches_refused():
    _refusal_test("tied")


def test_cond_param_predicate_refused():
    _refusal_test("predicate")


def test_cond_param_flows_out_refused():
    _refusal_test("flows_out")


def test_cond_inside_scan_refused():
    _refusal_test("inside_scan")


def test_cond_embedding_refused():
    _refusal_test("embedding")


def test_scan_inside_cond_refused():
    """A scan inside a branch around a covered weight (JAX ``collector.py:623-628``)."""
    _refusal_test("scan_in_branch")


def test_cond_bias_only_in_branch_refused():
    """A bias-only block inside a branch (JAX ``collector.py:887-892``)."""

    class BiasOnly(nn.Module):
        def __init__(self):
            super().__init__()
            self.b = nn.Parameter(torch.zeros(3))

        def forward(self, x):  # noqa: D102
            return torch.cond(x.sum() > 0, lambda h: h + self.b, lambda h: h, (x,))

    with pytest.raises(ValueError, match="cond"):
        _kfac(BiasOnly(), [(torch.ones(2, 3), torch.ones(2, 3))])


def test_cond_ekfac_matches_jax():
    """EKFAC on the two-branch model: the untaken branch's block is exactly
    0.0 (its corrected eigenvalues vanish with its output gradients), and
    the operator equals JAX's EKFAC."""
    params, X, y = _branches_case()
    model = Branches(params)
    ekfac = EKFACLinearOperator(model, MSELoss("mean"), dict(model.named_parameters()),
                                [(torch.tensor(X), torch.tensor(y))], fisher_type="type-2",
                                check_deterministic=False)
    dense = dense_of(ekfac)
    assert dense[8:].abs().max().item() == 0.0 and dense[:8, :8].abs().max().item() > 0
    jk = JEKFAC(_jax_branches(), JMSELoss("mean"), params, [(X, y)],
                fisher_type=JFisherType.TYPE2, check_deterministic=False)
    assert_close(dense, np.asarray(jk.todense()), rtol=5e-4, atol=1e-5, name="ekfac vs JAX")


# --------------------------------------------------------------------- #
# the curvature operators on a cond model (utils/cond.py)
# --------------------------------------------------------------------- #
@functools.cache
def _jax_operator_dense(which: str) -> np.ndarray:
    params, X, y = _branches_case()
    cls = {"ggn": JGGN, "hessian": JHessian}[which]
    op = cls(_jax_branches(jnp.tanh), JMSELoss("mean"), params, [(X, y)],
             check_deterministic=False)
    return np.asarray(jax.jit(lambda: op @ jnp.eye(op.shape[1]))())


@pytest.mark.parametrize("which", ["ggn", "hessian"])
def test_cond_curvature_matches_jax(which):
    """The port's GGN and Hessian of a cond model equal JAX's: the taken
    branch's curvature, zero rows for the untaken branch's weight."""
    params, X, y = _branches_case()
    model = Branches(params, torch.tanh)
    cls = {"ggn": GGNLinearOperator, "hessian": HessianLinearOperator}[which]
    op = cls(model, MSELoss("mean"), dict(model.named_parameters()),
             [(torch.tensor(X), torch.tensor(y))])  # with the determinism probe
    dense = dense_of(op)
    assert dense[8:].abs().max().item() == 0.0 and dense[:8, :8].abs().max().item() > 0
    assert_close(dense, _jax_operator_dense(which), rtol=1e-4, atol=1e-6, name=which)


def test_cond_ggn_diagonal_per_datum_predicate():
    """Under the diagonal's per-datum ``vmap`` the predicate is batched: both
    branches run and each datum takes its own (JAX's vmap-of-cond select)."""
    rng = np.random.default_rng(7)
    params = {k: (0.5 * rng.standard_normal((4, 2))).astype(np.float32) for k in ("Wa", "Wb")}
    X = rng.standard_normal((6, 4)).astype(np.float32)
    y = rng.standard_normal((6, 2)).astype(np.float32)

    class PerDatum(Branches):
        def forward(self, x):  # noqa: D102
            return torch.cond(x.sum() > 0, lambda h: torch.tanh(h @ self.Wa),
                              lambda h: h @ self.Wb, (x,))

    def jfn(p, x):
        return jax.lax.cond(jnp.sum(x) > 0, lambda h: jnp.tanh(h @ p["Wa"]),
                            lambda h: h @ p["Wb"], x)

    model = PerDatum(params)
    diag = GGNDiagonalLinearOperator(model, MSELoss("sum"), dict(model.named_parameters()),
                                     [(torch.tensor(X), torch.tensor(y))],
                                     check_deterministic=False)
    jdiag = JGGNDiagonal(jfn, JMSELoss("sum"), params, [(X, y)], check_deterministic=False)
    ones = jax.tree.map(jnp.ones_like, params)
    expected = np.concatenate([np.ravel(v) for v in jax.tree.leaves(jdiag @ ones)])
    mine = dense_of(diag).diagonal()
    signs = X.sum(1) > 0
    assert 0 < signs.sum() < len(signs)  # both branches taken by some datum
    assert_close(mine, expected, rtol=1e-4, atol=1e-6, name="ggn diagonal")


# --------------------------------------------------------------------- #
# the collector's conv coverage against JAX's KFAC (EXPAND and REDUCE)
# --------------------------------------------------------------------- #
def _conv_pair(kind: str, rng):
    """``(jax_fn, jax_params, torch_model, X_jax, to_torch_input)`` of a conv
    net whose last op is a spatial mean (REDUCE's pooled output) or the
    channels-last map."""
    if kind == "grouped":  # nn.Conv2d(groups=2) on group-replicated channels, NHWC/HWIO
        W = (0.4 * rng.standard_normal((3, 3, 2, 4))).astype(np.float32)
        b = (0.1 * rng.standard_normal(4)).astype(np.float32)
        base = rng.standard_normal((2, 5, 5, 2)).astype(np.float32)
        X = np.concatenate([base, base], axis=-1)

        def jfn(p, x):
            z = jax.lax.conv_general_dilated(
                x, p["conv"]["W"], (1, 1), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"),
                feature_group_count=2)
            return z + p["conv"]["b"]

        class Model(nn.Module):
            def __init__(self):
                super().__init__()
                self.conv = nn.Conv2d(4, 4, 3, padding="same", groups=2)

            def forward(self, x):  # noqa: D102
                return self.conv(x).permute(0, 2, 3, 1)

        return jfn, {"conv": {"W": W, "b": b}}, Model(), X, (0, 3, 1, 2)
    if kind == "dilated":  # F.conv2d on an HWIO leaf from NHWC, dilation 2, stride 2
        W = (0.4 * rng.standard_normal((2, 2, 3, 2))).astype(np.float32)
        X = rng.standard_normal((3, 7, 6, 3)).astype(np.float32)

        def jfn(p, x):
            return jax.lax.conv_general_dilated(
                x, p["conv"]["W"], (2, 1), "VALID", rhs_dilation=(2, 2),
                dimension_numbers=("NHWC", "HWIO", "NHWC"))

        class Model(nn.Module):
            def __init__(self):
                super().__init__()
                self.conv = nn.Module()
                self.conv.weight = nn.Parameter(torch.tensor(W))

            def forward(self, x):  # noqa: D102
                z = F.conv2d(x.permute(0, 3, 1, 2), self.conv.weight.permute(3, 2, 0, 1),
                             stride=(2, 1), dilation=2)
                return z.permute(0, 2, 3, 1)

        return jfn, {"conv": {"W": W}}, Model(), X, None
    # 1-D: an nn.Conv1d (dilation 2, "same") then F.conv1d on a WIO leaf
    W0 = (0.4 * rng.standard_normal((2, 3, 3))).astype(np.float32)  # WIO
    W1 = (0.4 * rng.standard_normal((1, 3, 2))).astype(np.float32)  # WIO
    b1 = (0.1 * rng.standard_normal(2)).astype(np.float32)
    X = rng.standard_normal((2, 9, 3)).astype(np.float32)

    def jfn(p, x):
        z = jax.lax.conv_general_dilated(x, p["c0"]["W"], (1,), "SAME", rhs_dilation=(2,),
                                         dimension_numbers=("NWC", "WIO", "NWC"))
        z = jax.lax.conv_general_dilated(z, p["c1"]["W"], (1,), "VALID",
                                         dimension_numbers=("NWC", "WIO", "NWC"))
        return z + p["c1"]["b"]

    class Model(nn.Module):
        def __init__(self):
            super().__init__()
            self.c0 = nn.Conv1d(3, 3, 2, padding="same", dilation=2, bias=False)
            with torch.no_grad():
                self.c0.weight.copy_(torch.tensor(W0).permute(2, 1, 0))
            self.c1 = nn.Module()
            self.c1.weight = nn.Parameter(torch.tensor(W1))
            self.c1.bias = nn.Parameter(torch.tensor(b1))

        def forward(self, x):  # noqa: D102
            z = self.c0(x.permute(0, 2, 1))
            z = F.conv1d(z, self.c1.weight.permute(2, 1, 0)) + self.c1.bias.reshape(1, -1, 1)
            return z.permute(0, 2, 1)

    return jfn, {"c0": {"W": W0}, "c1": {"W": W1, "b": b1}}, Model(), X, None


@pytest.mark.parametrize("approx", ["expand", "reduce"])
@pytest.mark.parametrize("kind", ["grouped", "dilated", "conv1d"])
def test_conv_coverage_matches_jax(kind, approx):
    """Grouped (group-replicated input), dilated and strided function-level,
    and 1-D (module and function-level) convs build and equal JAX's KFAC."""
    rng = np.random.default_rng(["grouped", "dilated", "conv1d"].index(kind))
    jfn, jparams, model, X, to_torch = _conv_pair(kind, rng)
    if kind == "grouped":
        with torch.no_grad():
            model.conv.weight.copy_(torch.tensor(jparams["conv"]["W"]).permute(3, 2, 0, 1))
            model.conv.bias.copy_(torch.tensor(jparams["conv"]["b"]))
    reduce = approx == "reduce"
    if reduce:
        mean_axes = tuple(range(1, X.ndim - 1))
        jmodel = lambda p, x: jnp.mean(jfn(p, x), axis=mean_axes)  # noqa: E731
        forward = model.forward
        model.forward = lambda x: forward(x).mean(dim=mean_axes)
    else:
        jmodel = jfn
    y = rng.standard_normal(np.shape(jmodel(jparams, X))).astype(np.float32)
    jk = JKFAC(jmodel, JMSELoss("mean"), jparams, [(X, y)], fisher_type=JFisherType.TYPE2,
               kfac_approx=JKFACType.REDUCE if reduce else JKFACType.EXPAND,
               check_deterministic=False)
    Xt = torch.tensor(X if to_torch is None else X.transpose(to_torch))
    kfac = _kfac(model, [(Xt, torch.tensor(y))], kfac_approx=approx)
    names = list(dict(model.named_parameters()))
    perm = port_order(jparams, model, names)
    expected = np.asarray(jk.todense())[np.ix_(perm, perm)]
    assert_close(dense_of(kfac), expected, rtol=1e-4, atol=1e-6, name=f"{kind} {approx}")
