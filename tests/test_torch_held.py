"""The port's held linearizations (``op.linearized()``), on the CPU.

The JAX package's ``tests/test_held.py`` carried over: the held operator
equals its base (Hessian, GGN and EF, mean and sum, in float64 to 1e-10),
ReLU's residuals, the MC Fisher with the same samples, cross-entropy and the
operator algebra, the Jacobian pair and its adjoint, composition with CG and
Hutchinson, the KFAC and flash refusals, and ``remat``; beyond it, no module
call in a held matvec, and each base class against the JAX package's own
``op.linearized()``, float64.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from curvlinops_tpu.curvature.ef import EFLinearOperator as JEF
from curvlinops_tpu.curvature.ggn import GGNLinearOperator as JGGN
from curvlinops_tpu.curvature.hessian import HessianLinearOperator as JHessian
from curvlinops_tpu.curvature.jacobian import JacobianLinearOperator as JJacobian
from curvlinops_tpu.losses import MSELoss as JMSELoss
from curvlinops_tpu_torch import (
    CGInverseLinearOperator,
    CrossEntropyLoss,
    EFLinearOperator,
    GGNLinearOperator,
    HessianLinearOperator,
    IdentityLinearOperator,
    JacobianLinearOperator,
    KFACLinearOperator,
    MSELoss,
    hutchinson_trace,
)
from curvlinops_tpu_torch.curvature.held import save_smaller_than
from curvlinops_tpu_torch.models.flash_attention import FORWARD_MODE_REFUSAL
from curvlinops_tpu_torch.models.gpt import TINY_GPT, shakespeare_nanogpt
from tests.test_torch_helpers import capped_torch_threads, rel_fro

_threads = capped_torch_threads()

TOL = 1e-10  # float64
CURVATURE = {"hessian": HessianLinearOperator, "ggn": GGNLinearOperator, "ef": EFLinearOperator}


def mlp_case(seed: int = 0, ce: bool = False, relu: bool = False):
    """The JAX test's MLP (6-8-4, tanh or ReLU), float64 numpy draws of
    ``seed``, two batches of 5 and 3: ``(model, params, data)``."""
    rng = np.random.default_rng(seed)
    params = {
        "l1": {"W": 0.4 * rng.standard_normal((6, 8)), "b": 0.1 * rng.standard_normal(8)},
        "l2": {"W": 0.4 * rng.standard_normal((8, 4)), "b": 0.1 * rng.standard_normal(4)},
    }
    act = torch.relu if relu else torch.tanh

    def model(p, x):
        h = act(x @ p["l1"]["W"] + p["l1"]["b"])
        return h @ p["l2"]["W"] + p["l2"]["b"]

    data = []
    for n in (5, 3):
        X = rng.standard_normal((n, 6))
        y = rng.integers(0, 4, size=n) if ce else rng.standard_normal((n, 4))
        data.append((X, y))
    to_t = lambda a: torch.from_numpy(np.asarray(a))  # noqa: E731
    tparams = {k: {n: to_t(a) for n, a in v.items()} for k, v in params.items()}
    return model, tparams, [(to_t(X), to_t(y)) for X, y in data], params


def dense(op) -> np.ndarray:
    return op.todense().numpy()


def mlp_module(params: dict, relu: bool = False) -> nn.Module:
    """:func:`mlp_case`'s model as an ``nn.Module`` (so forward hooks count
    its calls) with ``params``' values."""
    module = nn.Sequential(nn.Linear(6, 8), nn.ReLU() if relu else nn.Tanh(), nn.Linear(8, 4))
    with torch.no_grad():
        for i, key in ((0, "l1"), (2, "l2")):
            module[i].weight.copy_(params[key]["W"].T)
            module[i].bias.copy_(params[key]["b"])
    return module.double()


@pytest.fixture(scope="module")
def held_ops():
    """``{(op, reduction, relu): (base, held, call counter)}``: each held
    operator built once, on the module MLP with a forward-hook counter."""
    out = {}
    for relu, seed, reductions in ((False, 0, ("mean", "sum")), (True, 5, ("mean",))):
        _, params, data, _ = mlp_case(seed=seed, relu=relu)
        module = mlp_module(params, relu)
        calls = []
        for m in module.modules():
            m.register_forward_hook(lambda *_, calls=calls: calls.append(1))
        named = dict(module.named_parameters())
        for op, cls in CURVATURE.items():
            for reduction in reductions:
                base = cls(module, MSELoss(reduction), named, data, check_deterministic=False)
                out[op, reduction, relu] = (base, base.linearized(), calls)
    return out


@pytest.mark.parametrize("reduction", ["mean", "sum"])
@pytest.mark.parametrize("op", list(CURVATURE))
def test_held_equals_base(held_ops, op, reduction):
    base, held, _ = held_ops[op, reduction, False]
    assert rel_fro(dense(held), dense(base)) < TOL


@pytest.mark.parametrize("op", list(CURVATURE))
def test_held_relu_residuals(held_ops, op):
    """ReLU's linearization reads its output (a mask in effect): held too."""
    base, held, _ = held_ops[op, "mean", True]
    assert rel_fro(dense(held), dense(base)) < TOL


def test_held_mc_fisher_same_samples():
    """The held MC Fisher draws its samples once, from the base's per-batch
    generators: the same matrix."""
    model, params, data, _ = mlp_case(seed=1)
    base = GGNLinearOperator(model, MSELoss("mean"), params, data, mc_samples=3, seed=7,
                             check_deterministic=False)
    held = base.linearized()
    assert rel_fro(dense(held), dense(base)) < TOL
    other = GGNLinearOperator(model, MSELoss("mean"), params, data, mc_samples=3, seed=8,
                              check_deterministic=False)
    assert rel_fro(dense(held), dense(other)) > 1e-3


def test_held_cross_entropy_and_algebra():
    model, params, data, _ = mlp_case(seed=2, ce=True)
    base = GGNLinearOperator(model, CrossEntropyLoss("mean"), params, data,
                             check_deterministic=False)
    held = base.linearized()
    assert rel_fro(dense(held), dense(base)) < TOL
    v = np.random.default_rng(0).standard_normal(held.shape[1])
    combo = 2.0 * held + base
    assert isinstance(combo @ v, np.ndarray)
    assert rel_fro(combo @ v, 3.0 * (base @ v)) < TOL


def test_held_jacobian_pair():
    """Held ``J`` / ``J^T`` equal the base operators and stay mutual
    adjoints (ragged batches: the concatenated and sliced rows)."""
    model, params, data, _ = mlp_case(seed=6, relu=True)
    J = JacobianLinearOperator(model, params, data, check_deterministic=False)
    held_J = J.linearized()
    assert rel_fro(dense(held_J), dense(J)) < TOL
    held_JT = held_J.adjoint()
    assert rel_fro(dense(held_JT), dense(J.adjoint())) < TOL
    assert rel_fro(dense(held_JT), dense(held_J).T) < TOL


def test_held_composes_with_solver_and_estimator():
    """A held operator drops into CG and the estimators: the same solve, and
    the same Hutchinson estimate on the same probes."""
    model, params, data, _ = mlp_case(seed=7, relu=True)
    base = GGNLinearOperator(model, MSELoss("mean"), params, data, check_deterministic=False)
    held = base.linearized()
    eye = IdentityLinearOperator(base.in_spec)
    v = np.random.default_rng(1).standard_normal(base.shape[1])
    inv_b = CGInverseLinearOperator(base + 0.1 * eye, maxiter=400, tol=1e-12)
    inv_h = CGInverseLinearOperator(held + 0.1 * eye, maxiter=400, tol=1e-12)
    assert rel_fro(inv_h @ v, inv_b @ v) < 1e-9
    estimates = [float(hutchinson_trace(A, 32, generator=torch.Generator().manual_seed(11)))
                 for A in (held, base)]
    assert abs(estimates[0] - estimates[1]) <= TOL * abs(estimates[1])


def test_held_kfac_and_flash_refused():
    model, params, data, _ = mlp_case(seed=3)
    module = nn.Sequential(nn.Linear(6, 8), nn.Tanh(), nn.Linear(8, 4)).double()
    kfac = KFACLinearOperator(module, MSELoss("mean"), dict(module.named_parameters()),
                              data, check_deterministic=False)
    with pytest.raises((NotImplementedError, AttributeError)):
        kfac.linearized()
    gpt = shakespeare_nanogpt(2, TINY_GPT, seed=0, device="cpu", attention_impl="flash")
    base = GGNLinearOperator(gpt.model, gpt.loss_fn, gpt.params, gpt.data,
                             check_deterministic=False)
    with pytest.raises(NotImplementedError) as err:
        base.linearized()
    assert str(err.value) == FORWARD_MODE_REFUSAL


@pytest.mark.parametrize("op", list(CURVATURE))
def test_held_matvec_calls_no_module(held_ops, op):
    """Every module call happens at hold time; a held matvec calls none (a
    forward-hook counter), where the base's calls each module per batch."""
    base, held, calls = held_ops[op, "mean", False]
    v = torch.randn(base.shape[1], generator=torch.Generator().manual_seed(0),
                    dtype=torch.float64)
    calls.clear()
    expected = base @ v
    assert len(calls) > 0
    calls.clear()
    assert rel_fro(held @ v, expected) < TOL
    assert len(calls) == 0


@pytest.mark.parametrize("op", list(CURVATURE))
def test_held_remat_equals_held(held_ops, op):
    """``remat=True`` and a policy compute the same matrix; ``remat=True``
    holds fewer bytes (the rest is recomputed in each matvec)."""
    base, full, _ = held_ops[op, "mean", True]
    everything = base.linearized(remat=True)
    policy = base.linearized(remat=save_smaller_than(8 * 5 * 8))
    v = np.random.default_rng(0).standard_normal(base.shape[1])
    ref = full @ v
    assert rel_fro(everything @ v, ref) < TOL
    assert rel_fro(policy @ v, ref) < TOL
    assert everything.held_bytes < full.held_bytes


def test_held_remat_attention_scale_policy():
    """``save_smaller_than`` drops the ``[B, T, T]`` attention products of a
    toy attention model from the held values but keeps the projections."""
    B, T, D = 2, 16, 4
    rng = np.random.default_rng(5)
    params = {k: torch.from_numpy(0.3 * rng.standard_normal((D, D))) for k in "qkv"}

    def model(p, x):  # x: [B, T, D]
        q, k, v = x @ p["q"], x @ p["k"], x @ p["v"]
        a = torch.softmax(q @ k.transpose(1, 2) / D**0.5, dim=-1)
        return (a @ v).reshape(x.shape[0], -1)

    X = torch.from_numpy(rng.standard_normal((B, T, D)))
    y = torch.from_numpy(rng.standard_normal((B, T * D)))
    base = GGNLinearOperator(model, MSELoss("mean"), params, [(X, y)])
    full = base.linearized()
    # between the projections (B*T*D floats) and the attention rows (B*T*T)
    limited = base.linearized(remat=save_smaller_than(B * T * D * 8 + 1))
    assert limited.held_bytes < full.held_bytes - B * T * T * 8
    v = rng.standard_normal(base.shape[1])
    assert rel_fro(limited @ v, full @ v) < TOL


# ---------------------------------------------------------------------- #
# each base class against the JAX package's own held operator, float64
# ---------------------------------------------------------------------- #
JAX_CLASSES = {"hessian": JHessian, "ggn": JGGN, "ef": JEF}


def _jax_model(p, x):
    h = jnp.tanh(x @ p["l1"]["W"] + p["l1"]["b"])
    return h @ p["l2"]["W"] + p["l2"]["b"]


@pytest.fixture(scope="module")
def jax_held():
    """The JAX package's ``op.linearized().todense()`` for each class, once."""
    _, _, data, params = mlp_case(seed=8)
    data = data[:1]  # one batch: one compiled build and apply per operator
    out = {}
    with jax.enable_x64(True):
        jparams = jax.tree.map(jnp.asarray, params)
        jdata = [(jnp.asarray(X.numpy()), jnp.asarray(y.numpy())) for X, y in data]
        for name, cls in JAX_CLASSES.items():
            op = cls(_jax_model, JMSELoss("mean"), jparams, jdata, check_deterministic=False)
            out[name] = np.asarray(jax.block_until_ready(op.linearized().todense()))
        J = JJacobian(_jax_model, jparams, jdata, check_deterministic=False).linearized()
        out["jacobian"] = np.asarray(jax.block_until_ready(J.todense()))
    return out


@pytest.mark.parametrize("name", ["hessian", "ggn", "ef", "jacobian"])
def test_held_matches_jax_held(jax_held, name):
    model, params, data, _ = mlp_case(seed=8)
    data = data[:1]
    if name == "jacobian":
        base = JacobianLinearOperator(model, params, data, check_deterministic=False)
    else:
        base = CURVATURE[name](model, MSELoss("mean"), params, data, check_deterministic=False)
    assert rel_fro(dense(base.linearized()), jax_held[name]) < TOL
