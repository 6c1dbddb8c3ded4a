"""KFAC, EKFAC and the rank-r inverse over scan-stacked layer stacks, against
the JAX package's ``lax.scan`` KFAC and the port's own unrolled models.

The port's oracles of ``tests/test_kfac_scan.py``: a stack of
``StackedLinear`` slices applied by ``models/stack.py::scan`` must give the
operator of the unrolled model (each slice its own Kronecker block), and
the JAX package's scan KFAC on the same numpy weights and data (the tiny
stacked GPT's case is ``test_torch_kfac_scan_gpt.py``). Stacked
against unrolled in the port is the same float32 arithmetic slice by slice
(relative Frobenius error below 1e-5); against JAX the tolerances of
``tests/test_torch_gpt.py`` (1e-4 for matvecs, 1e-3 for inverses).
"""

import jax
import numpy as np
import pytest
import torch
from torch import nn

from curvlinops_tpu.kfac.ekfac import EKFACLinearOperator as JEKFAC
from curvlinops_tpu.kfac.operator import KFACLinearOperator as JKFAC
from curvlinops_tpu.losses import MSELoss as JMSELoss
from curvlinops_tpu_torch import examples as texamples
from curvlinops_tpu_torch.kfac.ekfac import EKFACLinearOperator
from curvlinops_tpu_torch.kfac.kfoc import KFOCLinearOperator
from curvlinops_tpu_torch.kfac.operator import KFACLinearOperator
from curvlinops_tpu_torch.losses import MSELoss
from curvlinops_tpu_torch.models.common import from_jax_params
from curvlinops_tpu_torch.models.stack import StackedLinear, scan
from tests.test_torch_helpers import capped_torch_threads, rel_fro

_threads = capped_torch_threads()

L, D, B = 3, 4, 8
EXACT_TOL = 1e-5  # stacked vs unrolled in the port: the same sums slice by slice
MATVEC_TOL, INVERSE_TOL = 1e-4, 1e-3  # against JAX, as tests/test_torch_gpt.py


class ScanMLP(nn.Module):
    """``L`` affine layers of ``width`` in one ``StackedLinear``, applied by
    ``scan``."""

    def __init__(self, remat: bool = False, width: int = D):
        super().__init__()
        self.lin, self.remat = StackedLinear(L, width, width), remat

    def forward(self, x):  # noqa: D102
        return scan(self.lin, x, L, remat=self.remat)


class UnrolledMLP(nn.Module):
    def __init__(self):
        super().__init__()
        for i in range(L):
            setattr(self, f"l{i}", nn.Linear(D, D))

    def forward(self, x):  # noqa: D102
        for i in range(L):
            x = getattr(self, f"l{i}")(x)
        return x


def jax_scan_mlp(params, x):
    def body(h, wb):
        W, b = wb
        return h @ W + b, None

    return jax.lax.scan(body, x, (params["lin"]["W"], params["lin"]["b"]))[0]


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(0)
    Ws = (0.3 * rng.standard_normal((L, D, D))).astype(np.float32)
    bs = (0.1 * rng.standard_normal((L, D))).astype(np.float32)
    X = rng.standard_normal((B, D)).astype(np.float32)
    y = rng.standard_normal((B, D)).astype(np.float32)
    jparams = {"lin": {"W": Ws, "b": bs}}
    stacked, unrolled = ScanMLP(), UnrolledMLP()
    stacked.load_state_dict(from_jax_params(jparams, stacked))
    unrolled.load_state_dict(
        from_jax_params({f"l{i}": {"W": Ws[i], "b": bs[i]} for i in range(L)}, unrolled)
    )
    halves = [(X[:4], y[:4]), (X[4:], y[4:])]
    v_jax = {"lin": {"W": rng.standard_normal((L, D, D)).astype(np.float32),
                     "b": rng.standard_normal((L, D)).astype(np.float32)}}
    return {
        "jparams": jparams, "jdata": halves, "stacked": stacked, "unrolled": unrolled,
        "data": [(torch.from_numpy(a), torch.from_numpy(b)) for a, b in halves],
        "v_jax": v_jax, "v": from_jax_params(v_jax, stacked),
    }


def _ops(case, cls, jcls, **kw):
    """The port's stacked and unrolled operators and JAX's scan operator."""
    loss = MSELoss("mean")
    s, u = case["stacked"], case["unrolled"]
    op_s = cls(s, loss, dict(s.named_parameters()), case["data"], **kw)
    op_u = cls(u, loss, dict(u.named_parameters()), case["data"], **kw)
    op_j = jcls(jax_scan_mlp, JMSELoss("mean"), case["jparams"], case["jdata"], **kw)
    return op_s, op_u, op_j


def _unrolled(v: dict) -> dict:
    return {
        f"l{i}.{leaf}": v[f"lin.{leaf}"][i] for i in range(L) for leaf in ("weight", "bias")
    }


def _assert_matches(op_s, op_u, op_j, case, tol_jax, what):
    """``op_s`` against the unrolled ``op_u`` and JAX's ``op_j``."""
    r_s, r_u = op_s @ case["v"], op_u @ _unrolled(case["v"])
    for name, expected in _unrolled(r_s).items():
        err = rel_fro(expected.detach().numpy(), r_u[name].detach().numpy())
        assert err < EXACT_TOL, f"{what} {name} vs unrolled: {err}"
    r_j = from_jax_params(jax.tree.map(np.asarray, op_j @ case["v_jax"]), case["stacked"])
    for name in r_j:
        err = rel_fro(r_s[name].detach().numpy(), r_j[name].numpy())
        assert err < tol_jax, f"{what} {name} vs JAX: {err}"


@pytest.mark.parametrize("separate", [True, False], ids=["separate", "joint"])
@pytest.mark.parametrize("fisher_type", ["type-2", "empirical", "forward-only"])
def test_scan_kfac_equals_unrolled_and_jax(case, separate, fisher_type):
    """Matvec, trace and Frobenius norm of the stacked KFAC: the unrolled
    model's, and JAX's scan KFAC's."""
    op_s, op_u, op_j = _ops(case, KFACLinearOperator, JKFAC, fisher_type=fisher_type,
                            separate_weight_and_bias=separate)
    assert all(g.stack == L for g in op_s.groups)
    assert [g.stack for g in op_j.groups] == [g.stack for g in op_s.groups]
    _assert_matches(op_s, op_u, op_j, case, MATVEC_TOL, "matvec")
    for prop in ("trace", "frobenius_norm"):
        a, b = float(getattr(op_s, prop)()), float(getattr(op_u, prop)())
        assert abs(a - b) <= 1e-5 * abs(b), prop
        assert abs(a - float(getattr(op_j, prop)())) <= 1e-4 * abs(b), prop


@pytest.mark.parametrize(
    "inv_kwargs",
    [
        {"damping": 0.1},
        {"damping": 0.1, "use_heuristic_damping": True},
        {"damping": 0.1, "use_exact_damping": True},
    ],
    ids=["plain", "heuristic", "exact"],
)
def test_scan_kfac_inverse_equals_unrolled_and_jax(case, inv_kwargs):
    """All three damping modes of the stacked inverse (batched Cholesky with
    per-slice heuristic damping, batched ``eigh``)."""
    op_s, op_u, op_j = _ops(case, KFACLinearOperator, JKFAC, fisher_type="type-2",
                            separate_weight_and_bias=False)
    _assert_matches(op_s.inverse(**inv_kwargs), op_u.inverse(**inv_kwargs),
                    op_j.inverse(**inv_kwargs), case, INVERSE_TOL, "inverse")


def test_scan_kfac_exact_deep_linear(case):
    """Stacked deep linear + MSE + type-2 is the per-slice block-diagonal of
    the exact GGN (the port's dense GGN), and JAX's dense scan KFAC."""
    op_s, _, op_j = _ops(case, KFACLinearOperator, JKFAC, fisher_type="type-2",
                         separate_weight_and_bias=False)
    s = case["stacked"]
    dense = texamples.dense_ggn(s, MSELoss("mean"), dict(s.named_parameters()), case["data"])
    nW = L * D * D  # flat order: weight [L, D, D], then bias [L, D]
    expected = torch.zeros_like(dense)
    for l in range(L):
        idx = torch.cat([torch.arange(l * D * D, (l + 1) * D * D),
                         torch.arange(nW + l * D, nW + (l + 1) * D)])
        expected[idx[:, None], idx] = dense[idx[:, None], idx]
    actual = op_s @ torch.eye(op_s.shape[1])
    assert rel_fro(actual.numpy(), expected.numpy()) < MATVEC_TOL
    jdense = np.asarray(op_j.todense())  # JAX's flat order: W [L, in, out], b
    perm = torch.cat([torch.arange(nW).reshape(L, D, D).transpose(1, 2).reshape(-1),
                      torch.arange(nW, nW + L * D)])
    assert rel_fro(actual.numpy(), jdense[np.ix_(perm.numpy(), perm.numpy())]) < MATVEC_TOL


@pytest.mark.parametrize("separate", [True, False], ids=["separate", "joint"])
def test_scan_ekfac_equals_unrolled_and_jax(case, separate):
    """EKFAC batches the stacked ``eigh`` and corrects slice by slice
    (``"seigh"`` blocks); its matvec and damped inverse."""
    op_s, op_u, op_j = _ops(case, EKFACLinearOperator, JEKFAC, fisher_type="type-2",
                            separate_weight_and_bias=separate)
    assert {kind for kind, _ in op_s._blocks_data.values()} == {"seigh"}
    _assert_matches(op_s, op_u, op_j, case, MATVEC_TOL, "ekfac")
    _assert_matches(op_s.inverse(0.1), op_u.inverse(0.1), op_j.inverse(0.1), case,
                    INVERSE_TOL, "ekfac inverse")


@pytest.mark.parametrize("separate", [True, False], ids=["separate", "joint"])
def test_scan_rank_r_exact_above_true_rank(separate):
    """``inverse(rank=3)`` (``"slreigh"`` blocks) and EKFAC at rank 3 on
    factors of rank 2 (empirical Fisher of two samples, width 6) are exact up
    to roundoff whatever the test matrix: held against JAX's exact-damped
    inverse and exact EKFAC."""
    width, rng = 6, np.random.default_rng(3)
    jparams = {"lin": {"W": (0.3 * rng.standard_normal((L, width, width))).astype(np.float32),
                       "b": (0.1 * rng.standard_normal((L, width))).astype(np.float32)}}
    X = rng.standard_normal((2, width)).astype(np.float32)
    y = rng.standard_normal((2, width)).astype(np.float32)
    model = ScanMLP(width=width)
    model.load_state_dict(from_jax_params(jparams, model))
    kw = dict(fisher_type="empirical", separate_weight_and_bias=separate)
    data = [(torch.from_numpy(X), torch.from_numpy(y))]
    params = dict(model.named_parameters())
    v_jax = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32), jparams)
    v = from_jax_params(v_jax, model)
    j = JKFAC(jax_scan_mlp, JMSELoss("mean"), jparams, [(X, y)], **kw)
    kfac = KFACLinearOperator(model, MSELoss("mean"), params, data, **kw)
    inv = kfac.inverse(damping=0.1, use_exact_damping=True, rank=3)
    assert {kind for kind, _ in inv._blocks_data.values()} == {"slreigh"}
    ek = EKFACLinearOperator(model, MSELoss("mean"), params, data, rank=3, **kw)
    assert {kind for kind, _ in ek._blocks_data.values()} == {"slreigh"}
    jek = JEKFAC(jax_scan_mlp, JMSELoss("mean"), jparams, [(X, y)], **kw)
    for port_op, jax_op, what in (
        (inv, j.inverse(damping=0.1, use_exact_damping=True), "rank-3 inverse"),
        (ek, jek, "rank-3 EKFAC"),
    ):
        out = port_op @ v
        expected = from_jax_params(jax.tree.map(np.asarray, jax_op @ v_jax), model)
        for name in expected:
            err = rel_fro(out[name].detach().numpy(), expected[name].numpy())
            assert err < INVERSE_TOL, f"{what} {name}: {err}"


def test_scan_shared_weight_equals_unrolled_tying():
    """A layer module called inside the loop shares its weight across the
    iterations: the unrolled weight-tied model's operator, and JAX's scan
    constant (``("shared", L)``), with no stack axis."""
    rng = np.random.default_rng(11)
    W = (0.3 * rng.standard_normal((D, D))).astype(np.float32)
    X = rng.standard_normal((B, D)).astype(np.float32)
    y = rng.standard_normal((B, D)).astype(np.float32)

    class Shared(nn.Module):
        def __init__(self, use_scan):
            super().__init__()
            self.lin, self.use_scan = nn.Linear(D, D, bias=False), use_scan

        def forward(self, x):  # noqa: D102
            if self.use_scan:
                return scan(lambda h, _: self.lin(h), x, L)
            for _ in range(L):
                x = self.lin(x)
            return x

    def jax_shared(p, x):
        return jax.lax.scan(lambda h, _: (h @ p["lin"]["W"], None), x, None, length=L)[0]

    jparams = {"lin": {"W": W}}
    data = [(torch.from_numpy(X), torch.from_numpy(y))]
    v_jax = {"lin": {"W": rng.standard_normal((D, D)).astype(np.float32)}}
    outs = []
    for use_scan in (True, False):
        m = Shared(use_scan)
        m.load_state_dict(from_jax_params(jparams, m))
        op = KFACLinearOperator(m, MSELoss("mean"), dict(m.named_parameters()), data,
                                fisher_type="type-2")
        assert [g.stack for g in op.groups] == [0]
        outs.append((op @ from_jax_params(v_jax, m))["lin.weight"])
    j = JKFAC(jax_shared, JMSELoss("mean"), jparams, [(X, y)], fisher_type="type-2")
    assert [g.stack for g in j.groups] == [0]
    expected = from_jax_params(jax.tree.map(np.asarray, j @ v_jax), m)["lin.weight"]
    assert rel_fro(outs[0].detach().numpy(), outs[1].detach().numpy()) < EXACT_TOL
    assert rel_fro(outs[0].detach().numpy(), expected.numpy()) < MATVEC_TOL


def test_scan_state_dict_roundtrip(case):
    """Stacked factors survive ``state_dict``/``load_state_dict`` and
    ``from_state_dict``."""
    s = case["stacked"]
    args = (s, MSELoss("mean"), dict(s.named_parameters()), case["data"])
    op = KFACLinearOperator(*args, fisher_type="type-2")
    state = {k: {i: t.clone() for i, t in d.items()} for k, d in op.state_dict().items()}
    assert state["aaT"]["0"].shape == (L, D, D)
    before = op @ case["v"]
    op.load_state_dict(state)
    rebuilt = KFACLinearOperator.from_state_dict(state, *args, fisher_type="type-2")
    for other in (op, rebuilt):
        after = other @ case["v"]
        for name in before:
            assert torch.equal(before[name], after[name]), name


# ---------------------------------------------------------------------- #
# refusals: never silently miscompute
# ---------------------------------------------------------------------- #
class _Refused(nn.Module):
    """Models the collector must refuse, one per ``mode``."""

    def __init__(self, mode: str):
        super().__init__()
        self.mode = mode
        self.lin = nn.Linear(D, D, bias=False)
        self.stack = StackedLinear(L, D, D, bias=False)

    def forward(self, x):  # noqa: D102
        if self.mode == "carry":  # the weight rides in the loop carry
            h, _ = scan(lambda c, _: (self.lin(c[0]), c[1] * 1.0), (x, self.lin.weight), L)
            return h
        if self.mode == "flows_out":  # the loop hands the weight out
            h, w = scan(lambda c, _: (self.lin(c[0]), self.lin.weight), (x, x), L)
            return h
        if self.mode == "nested":
            return scan(lambda h, l: scan(lambda hh, _: self.stack(hh, l), h, 2), x, L)
        if self.mode == "transposed":  # the stacked weight transposed before use
            W = self.stack.weight.transpose(1, 2)
            return scan(lambda h, l: h @ W[l], x, L)
        if self.mode == "tied":  # slice 0 applied twice, slice 2 never
            return scan(lambda h, l: self.stack(h, min(l, 1)), self.stack(x, 0), L)
        raise ValueError(self.mode)


@pytest.mark.parametrize(
    "mode, match",
    [("carry", "carry"), ("flows_out", "flows out"), ("nested", "nested"),
     ("transposed", "stacked"), ("tied", "tying a stacked leaf")],
)
def test_scan_refusals(mode, match):
    """The JAX collector's refusal set: a parameter in the carry, one that
    flows out of the loop, a scan in a scan, a stacked weight transposed
    before use, a stacked weight whose slices are not each used once."""
    model = _Refused(mode)
    names = ("lin.weight",) if mode in ("carry", "flows_out") else ("stack.weight",)
    params = {n: p for n, p in model.named_parameters() if n in names}
    X = torch.randn(B, D, generator=torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match=match):
        KFACLinearOperator(model, MSELoss("mean"), params, [(X, X)], fisher_type="type-2")


def test_scan_refuses_kfoc(case):
    s = case["stacked"]
    with pytest.raises(ValueError, match="scan-stacked"):
        KFOCLinearOperator(s, MSELoss("mean"), dict(s.named_parameters()), case["data"][:1],
                           fisher_type="type-2")


def test_remat_gives_the_same_factors(case):
    """``remat`` checkpoints the loop under plain autograd only: KFAC's
    tapped forward runs it without recomputation, so the factors are those
    of the model without remat (a recompute in backward would have fired
    the collector's hooks a second time)."""
    remat = ScanMLP(remat=True)
    remat.load_state_dict(case["stacked"].state_dict())
    factors = []
    for m in (case["stacked"], remat):
        op = KFACLinearOperator(m, MSELoss("mean"), dict(m.named_parameters()), case["data"],
                                fisher_type="empirical")
        factors.append((op._aaT, op._ggT))
    (a0, g0), (a1, g1) = factors
    assert all(torch.equal(a0[k], a1[k]) for k in a0)
    assert all(torch.equal(g0[k], g1[k]) for k in g0)
