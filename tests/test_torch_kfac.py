"""KFAC port against the JAX package and against exactness oracles.

On a narrow ResNet (one basic block per stage, widths 16/16/32/32) the
port's factors, matvec and damped inverses are held against JAX
``KFACLinearOperator``, matched by parameter name: the type-2 build with
``use_pallas=True`` (the Pallas kernel in interpret mode on the CPU), the
empirical one through the XLA patches path (input covariances do not depend
on the Fisher type, and interpret mode costs seconds of compilation). On tiny MLPs and a one-position conv
the port is held against the dense GGN it must equal exactly. All float32.
"""

import math

import jax
import numpy as np
import pytest
import torch
from torch import nn

from curvlinops_tpu.kfac.operator import KFACLinearOperator as JKFAC
from curvlinops_tpu.losses import CrossEntropyLoss as JCrossEntropyLoss
from curvlinops_tpu.models import resnet as jresnet
from curvlinops_tpu_torch.curvature.loss_hessian import sample_grad_outputs
from curvlinops_tpu_torch.kfac.operator import KFACLinearOperator
from curvlinops_tpu_torch.losses import CrossEntropyLoss, MSELoss
from curvlinops_tpu_torch.models.resnet import from_jax_params
from tests.test_torch_helpers import capped_torch_threads, jax_name, narrow_resnet, rel_fro

_threads = capped_torch_threads()

# relative Frobenius tolerances: factors and matvecs are float32 sums in
# another order (measured 3e-6); damped inverses amplify that by up to
# (largest eigenvalue / damping). The factors of a 2-image batch are rank
# deficient, and the eigenvalues of their null spaces carry float32 roundoff
# of ~1e-5, so exact damping is compared at damping 1.0 (measured 6e-5; at
# 1e-3 it is 1.4e-2 in both packages' arithmetic alike) and the heuristic
# split, which damps each factor by ~sqrt(damping), at 1e-3 (measured 7e-5)
FACTOR_TOL, MATVEC_TOL, INVERSE_TOL = 1e-4, 1e-4, 1e-3
DAMPING = {"heuristic": 1e-3, "exact": 1.0}


@pytest.fixture(scope="module")
def resnet_case():
    case = narrow_resnet()
    kfac_fn, kfac_params = jresnet.kfac_restricted(case["apply_fn"], case["jax_params"])
    case["jax_kfac_fn"], case["jax_kfac_params"] = kfac_fn, kfac_params
    case["torch_kfac_params"] = from_jax_params(
        jax.tree.map(np.asarray, kfac_params), case["model"]
    )
    case["ops"] = {}
    for fisher_type in ("type-2", "empirical"):
        jop = JKFAC(
            kfac_fn, JCrossEntropyLoss("mean"), kfac_params,
            [(case["X_nhwc"], case["y"])], fisher_type=fisher_type,
            use_pallas=fisher_type == "type-2", check_deterministic=False,
        )
        top = KFACLinearOperator(
            case["model"], CrossEntropyLoss("mean"), case["torch_kfac_params"],
            [(case["X"], case["y_t"])], fisher_type=fisher_type,
        )
        case["ops"][fisher_type] = (jop, top)
    rng = np.random.default_rng(0)
    case["v_jax"] = {
        k: rng.standard_normal(np.shape(p)).astype(np.float32)
        for k, p in kfac_params.items()
    }
    case["v"] = from_jax_params(case["v_jax"], case["model"])
    return case


def _by_name(jop, top):
    """Pairs of (JAX group index, port group index) with the same parameters."""
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


@pytest.mark.parametrize("fisher_type", ["type-2", "empirical"])
def test_factors_match_jax(resnet_case, fisher_type):
    jop, top = resnet_case["ops"][fisher_type]
    pairs = _by_name(jop, top)
    assert len(pairs) == 14  # 12 convs, the classifier weight and its bias
    for jgi, tgi in pairs:
        assert (jgi in jop._aaT) == (tgi in top._aaT)
        if jgi in jop._aaT:
            assert rel_fro(top._aaT[tgi], jop._aaT[jgi]) < FACTOR_TOL, top.groups[tgi].name
        assert rel_fro(top._ggT[tgi], jop._ggT[jgi]) < FACTOR_TOL, top.groups[tgi].name


def _assert_same_vector(actual: dict, expected_jax: dict, model, tol: float, what: str):
    expected = from_jax_params(jax.tree.map(np.asarray, expected_jax), model)
    assert list(actual) == list(expected) or sorted(actual) == sorted(expected)
    for name in expected:
        err = rel_fro(actual[name].detach().numpy(), expected[name].numpy())
        assert err < tol, f"{what} {name}: relative error {err}"


@pytest.mark.parametrize(
    "mode", ["matvec", "heuristic", "exact"], ids=["matvec", "inv_heuristic", "inv_exact"]
)
def test_matvec_and_inverses_match_jax(resnet_case, mode):
    jop, top = resnet_case["ops"]["type-2"]
    if mode == "matvec":
        jA, tA, tol = jop, top, MATVEC_TOL
    else:
        kw = {"use_heuristic_damping": True} if mode == "heuristic" else {"use_exact_damping": True}
        damping = DAMPING[mode]
        jA, tA, tol = jop.inverse(damping=damping, **kw), top.inverse(damping=damping, **kw), INVERSE_TOL
    _assert_same_vector(
        tA @ resnet_case["v"], jA @ resnet_case["v_jax"], resnet_case["model"], tol, mode
    )


def test_trace_and_norm_match_jax(resnet_case):
    jop, top = resnet_case["ops"]["type-2"]
    assert math.isclose(float(top.trace()), float(jop.trace()), rel_tol=FACTOR_TOL)
    assert math.isclose(
        float(top.frobenius_norm()), float(jop.frobenius_norm()), rel_tol=FACTOR_TOL
    )


# ---------------------------------------------------------------------- #
# exactness oracles (the JAX package's tests/test_kfac.py, ported)
# ---------------------------------------------------------------------- #
def dense_ggn(model, loss_fn, params: dict, data) -> torch.Tensor:
    """Dense ``sum_batches c J^T H_loss J`` over the flattened parameters."""
    names = list(params)
    shapes = [params[n].shape for n in names]
    flat = torch.cat([params[n].detach().reshape(-1) for n in names])
    N = sum(X.shape[0] for X, _ in data)

    def unflat(v):
        parts = torch.split(v, [math.prod(s) for s in shapes])
        return {n: p.reshape(s) for n, p, s in zip(names, parts, shapes)}

    G = torch.zeros(flat.numel(), flat.numel(), dtype=torch.float64)
    for X, y in data:
        c = X.shape[0] / N if loss_fn.reduction == "mean" else 1.0
        pred = torch.func.functional_call(model, unflat(flat), (X,))
        J = torch.func.jacrev(
            lambda v: torch.func.functional_call(model, unflat(v), (X,)).reshape(-1)
        )(flat)
        H = torch.func.hessian(lambda pf: loss_fn(pf.reshape(pred.shape), y))(
            pred.detach().reshape(-1)
        )
        G += c * (J.T @ H @ J).double()
    return G


def blockdiag_projection(dense: torch.Tensor, params: dict, groups) -> torch.Tensor:
    """Zero ``dense`` outside the KFAC blocks (keeping W+b cross blocks of joint groups)."""
    ranges, start = {}, 0
    for n, p in params.items():
        ranges[n] = range(start, start + p.numel())
        start += p.numel()
    out = torch.zeros_like(dense)
    for g in groups:
        idx = [i for n in (g.weight_path, g.bias_path) if n is not None for i in ranges[n]]
        idx = torch.tensor(idx)
        out[idx[:, None], idx[None, :]] = dense[idx[:, None], idx[None, :]]
    return out


def _kfac_vs_ggn(model, loss_fn, data, rtol, **kw):
    params = dict(model.named_parameters())
    kfac = KFACLinearOperator(model, loss_fn, params, data, fisher_type="type-2", **kw)
    expected = blockdiag_projection(dense_ggn(model, loss_fn, params, data), params, kfac.groups)
    np.testing.assert_allclose(
        kfac.todense().double().numpy(), expected.numpy(), rtol=rtol, atol=1e-5
    )


@pytest.mark.parametrize("separate", [True, False], ids=["separate", "joint"])
@pytest.mark.parametrize("reduction", ["mean", "sum"])
def test_exact_deep_linear_type2(reduction, separate):
    """Deep linear + MSE + type-2: KFAC equals the block-diagonal GGN
    (rtol 5e-4, atol 1e-5, as in the JAX package's oracle)."""
    gen = torch.Generator().manual_seed(0)
    torch.manual_seed(0)
    model = nn.Sequential(nn.Linear(4, 3), nn.Linear(3, 2))
    X, y = torch.randn(8, 4, generator=gen), torch.randn(8, 2, generator=gen)
    data = [(X[:4], y[:4]), (X[4:], y[4:])]
    _kfac_vs_ggn(model, MSELoss(reduction), data, 5e-4, separate_weight_and_bias=separate)


def test_exact_one_datum_type2_mlp():
    """One datum, no weight sharing: exact for a nonlinear CE network (rtol 1e-3)."""
    gen = torch.Generator().manual_seed(1)
    torch.manual_seed(1)
    model = nn.Sequential(nn.Linear(6, 7), nn.Tanh(), nn.Linear(7, 4))
    data = [(torch.randn(1, 6, generator=gen), torch.tensor([2]))]
    _kfac_vs_ggn(model, CrossEntropyLoss("mean"), data, 1e-3)


def test_exact_one_datum_conv_no_sharing():
    """A conv whose kernel covers its input (one output position): exact,
    which checks the conv patch and canonical-weight math (rtol 1e-3)."""
    gen = torch.Generator().manual_seed(2)
    torch.manual_seed(2)
    model = nn.Sequential(
        nn.Conv2d(2, 6, 4), nn.Flatten(), nn.Tanh(), nn.Linear(6, 3, bias=False)
    )
    data = [(torch.randn(1, 2, 4, 4, generator=gen), torch.tensor([1]))]
    _kfac_vs_ggn(model, CrossEntropyLoss("mean"), data, 1e-3)


# ---------------------------------------------------------------------- #
# MC path, checkpoints and refusals
# ---------------------------------------------------------------------- #
def _small_cnn():
    torch.manual_seed(3)
    model = nn.Sequential(
        nn.Conv2d(3, 4, 3, padding=1), nn.ReLU(), nn.Flatten(), nn.Linear(4 * 5 * 5, 3)
    )
    gen = torch.Generator().manual_seed(3)
    X = torch.randn(6, 3, 5, 5, generator=gen)
    y = torch.randint(0, 3, (6,), generator=gen)
    return model, dict(model.named_parameters()), [(X[:3], y[:3]), (X[3:], y[3:])]


def test_mc_same_seed_same_factors():
    model, params, data = _small_cnn()
    a = KFACLinearOperator(model, CrossEntropyLoss(), params, data, seed=7)
    b = KFACLinearOperator(model, CrossEntropyLoss(), params, data, seed=7)
    c = KFACLinearOperator(model, CrossEntropyLoss(), params, data, seed=8)
    assert all(torch.equal(a._ggT[g], b._ggT[g]) for g in a._ggT)
    assert all(torch.equal(a._aaT[g], b._aaT[g]) for g in a._aaT)
    assert any(not torch.equal(a._ggT[g], c._ggT[g]) for g in a._ggT)


def test_mc_ce_sampler_matches_loss_hessian():
    """E[g g^T] over 20000 draws matches diag(p) - p p^T within 0.02 (over
    five standard errors of the mean of the outer products)."""
    logits = torch.tensor([[1.0, -0.5, 0.3, 2.0]])
    gen = torch.Generator().manual_seed(0)
    g = sample_grad_outputs(CrossEntropyLoss("sum"), logits, torch.tensor([0]), gen, 20_000)[0]
    p = torch.softmax(logits[0], dim=0)
    expected = torch.diag(p) - torch.outer(p, p)
    assert torch.allclose(g.T @ g / g.shape[0], expected, atol=0.02)


def test_state_dict_round_trip():
    model, params, data = _small_cnn()
    kfac = KFACLinearOperator(model, CrossEntropyLoss(), params, data, fisher_type="type-2")
    restored = KFACLinearOperator.from_state_dict(
        kfac.state_dict(), model, CrossEntropyLoss(), params, data
    )
    v = torch.randn(kfac.shape[0])
    assert torch.equal(kfac @ v, restored @ v)


class _ReadsWeightOutside(nn.Module):
    def __init__(self):
        super().__init__()
        self.fc = nn.Linear(3, 2)

    def forward(self, x):
        return self.fc(x) + x @ self.fc.weight.T


@pytest.mark.parametrize(
    "model,match",
    [
        (_ReadsWeightOutside(), "read outside"),
        (nn.Sequential(nn.Conv2d(3, 3, 3, dilation=2), nn.Flatten()), "dilation"),
        (nn.Sequential(nn.Conv2d(3, 3, 3, groups=3), nn.Flatten()), "groups"),
        (nn.Sequential(nn.LayerNorm(3), nn.Linear(3, 2)), "not the weight/bias"),
    ],
    ids=["outside_read", "dilation", "groups", "layernorm"],
)
def test_refuses_unsupported_uses(model, match):
    X = torch.randn(2, 3, 5, 5) if isinstance(model[0] if isinstance(model, nn.Sequential) else None, nn.Conv2d) else torch.randn(2, 3)
    y = torch.zeros(X.shape[0], dtype=torch.long)
    with pytest.raises(ValueError, match=match):
        KFACLinearOperator(
            model, CrossEntropyLoss(), dict(model.named_parameters()), [(X, y)],
            check_deterministic=False,
        )
