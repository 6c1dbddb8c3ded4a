"""The bfloat16 speed mode, against the JAX package, on the CPU.

Twins of ``tests/test_bfloat16.py``: the JAX package's tests pin the dtype
plumbing of its speed mode (models and parameters in bfloat16: outputs stay
bfloat16, KFAC's factors are float32, nothing silently upcasts) and check
the numbers loosely against float32. Here the same numpy inputs, rounded to
bfloat16 by each package, go through both: the port's bfloat16 results keep
the same dtypes, stay within JAX's own bound of 5e-2 (relative Frobenius)
of the port's float32 operator, and within 5e-2 of the JAX package's
bfloat16 results (the two round at other places, each to about 2^-8). The
MC draws of the two packages differ, so the KFAC comparisons with JAX use
type-2, whose factors are exact; the MC builds are held for their dtypes.
On a deeper net bfloat16 loses more than 5e-2: on a narrow ResNet the
port's bfloat16 GGN deviates from float32 as much as the JAX package's does
(about a quarter), which is what the card's ResNet-18 bounds on its
factors and GGN (``chip_smoke.BF16_RESNET_TOLS``) start from. The JAX
oracles run as single ``jax.jit`` calls on numpy inputs.
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
from curvlinops_tpu_torch.models.common import from_jax_params
from tests.test_torch_helpers import capped_torch_threads, rel_fro

_threads = capped_torch_threads()

BF16_TOL = 5e-2  # JAX's bound in test_bf16_matvec_dtype_and_magnitude
F32_TOL = 1e-5  # float32, the port against JAX (summation order)

_RNG = np.random.default_rng(0)
W1 = (0.4 * _RNG.standard_normal((6, 16))).astype(np.float32)
W2 = (0.4 * _RNG.standard_normal((16, 4))).astype(np.float32)
X = _RNG.standard_normal((24, 6)).astype(np.float32)
Y = _RNG.integers(0, 4, 24)


class _MLP(nn.Module):
    """``tanh(x W1 + b1) W2``, the JAX test's model."""

    def __init__(self):
        super().__init__()
        self.l0 = nn.Linear(6, 16)
        self.l1 = nn.Linear(16, 4, bias=False)

    def forward(self, x):  # noqa: D102
        return self.l1(torch.tanh(self.l0(x)))


def _jax_tree() -> dict:
    return {"l0": {"W": W1, "b": np.zeros(16, np.float32)}, "l1": {"W": W2}}


def _jax_problem(dtype):
    """The JAX test's problem (two batches of 12) in ``dtype``, as numpy
    arrays: JAX's eager casts and slices compile one program each."""
    params = jax.tree.map(lambda a: a.astype(dtype), _jax_tree())

    def model_fn(p, x):
        return jnp.tanh(x @ p["l0"]["W"] + p["l0"]["b"]) @ p["l1"]["W"]

    Xj, yj = X.astype(dtype), Y
    return model_fn, params, [(Xj[:12], yj[:12]), (Xj[12:], yj[12:])]


def _port_problem(dtype):
    """The same problem in the port: weights from the same numpy arrays."""
    model = _MLP()
    model.load_state_dict(from_jax_params(_jax_tree(), model))
    model = model.to(dtype)
    Xt, yt = torch.from_numpy(X).to(dtype), torch.from_numpy(Y)
    return model, dict(model.named_parameters()), [(Xt[:12], yt[:12]), (Xt[12:], yt[12:])]


def _as_port(tree: dict, model) -> dict:
    """A JAX result tree as the port's named float32 tensors."""
    return from_jax_params(jax.tree.map(lambda a: np.asarray(a, np.float32), tree), model)


def _flat(tree: dict) -> np.ndarray:
    """The tree's tensors by sorted name, concatenated, as float32."""
    return np.concatenate([tree[n].detach().float().reshape(-1).numpy() for n in sorted(tree)])


def _ones(params: dict, cols: bool = False) -> dict:
    return {n: torch.ones(p.shape + ((1,) if cols else ()), dtype=p.dtype)
            for n, p in params.items()}


OPS = {
    "ggn": (cl.GGNLinearOperator, T.GGNLinearOperator),
    "hessian": (cl.HessianLinearOperator, T.HessianLinearOperator),
    "ef": (cl.EFLinearOperator, T.EFLinearOperator),
}


@pytest.mark.parametrize("op", sorted(OPS))
def test_bf16_matvec_dtype_and_magnitude(op):
    """The matvec of ones in bfloat16: every leaf bfloat16 and finite,
    within 5e-2 of the port's float32 operator and of JAX's bfloat16
    matvec; the float32 operators agree with JAX's to 1e-5."""
    j_cls, t_cls = OPS[op]
    out = {}
    for dtype, jdtype in ((torch.bfloat16, jnp.bfloat16), (torch.float32, jnp.float32)):
        model, params, data = _port_problem(dtype)
        A = t_cls(model, T.CrossEntropyLoss("mean"), params, data, check_deterministic=False)
        out[dtype] = A.matvec_tree(_ones(params))
        model_fn, jparams, jdata = _jax_problem(jdtype)
        J = j_cls(model_fn, cl.CrossEntropyLoss("mean"), jparams, jdata,
                  check_deterministic=False)
        ones = jax.tree.map(np.ones_like, jparams)
        out[jdtype] = _as_port(jax.jit(J.matvec_tree)(ones), model)
    for leaf in out[torch.bfloat16].values():
        assert leaf.dtype == torch.bfloat16 and bool(torch.isfinite(leaf.float()).all())
    bf16 = _flat(out[torch.bfloat16])
    assert rel_fro(bf16, _flat(out[torch.float32])) < BF16_TOL
    assert rel_fro(bf16, _flat(out[jnp.bfloat16])) < BF16_TOL
    assert rel_fro(_flat(out[torch.float32]), _flat(out[jnp.float32])) < F32_TOL


def test_bf16_gradient_and_loss_fused():
    """A bfloat16 model whose loss runs in float32 (logits upcast): the
    fused gradient stays bfloat16 and the loss float32, both within 5e-2 of
    JAX's (the loss to 1e-2: one scalar of float32 sums over bfloat16
    logits)."""
    model, params, data = _port_problem(torch.bfloat16)

    class Upcast(nn.Module):
        def __init__(self, inner):
            super().__init__()
            self.inner = inner

        def forward(self, x):  # noqa: D102
            return self.inner(x).float()

    wrapped = Upcast(model)
    params = dict(wrapped.named_parameters())
    G = T.GGNLinearOperator(wrapped, T.CrossEntropyLoss("mean"), params, data,
                            check_deterministic=False)
    grad, loss = G.gradient_and_loss()
    assert loss.dtype == torch.float32
    assert all(g.dtype == torch.bfloat16 for g in grad.values())

    model_fn, jparams, jdata = _jax_problem(jnp.bfloat16)
    J = cl.GGNLinearOperator(lambda p, x: model_fn(p, x).astype(jnp.float32),
                             cl.CrossEntropyLoss("mean"), jparams, jdata,
                             check_deterministic=False)
    jgrad, jloss = jax.jit(J.gradient_and_loss)()
    jgrad = {f"inner.{n}": t for n, t in _as_port(jgrad, model).items()}
    assert rel_fro(_flat(grad), _flat(jgrad)) < BF16_TOL
    assert abs(float(loss) - float(jloss)) < 1e-2 * abs(float(jloss))


def _kfac_pair(fisher_type: str):
    """The port's bfloat16 KFAC and the port model (MC: one sample, seed 0)."""
    model, params, data = _port_problem(torch.bfloat16)
    kfac = T.KFACLinearOperator(model, T.CrossEntropyLoss("mean"), params, data,
                                fisher_type=fisher_type, mc_samples=1,
                                check_deterministic=False)
    return kfac, model, params, data


def test_bf16_kfac_build_and_inverse():
    """MC KFAC on the bfloat16 model: float32 factors, a finite matvec and
    damped inverse (as JAX's test); type-2 KFAC's bfloat16 matvec within
    5e-2 of JAX's bfloat16 type-2 KFAC's."""
    kfac, model, params, _ = _kfac_pair("mc")
    for factor in (*kfac._aaT.values(), *kfac._ggT.values()):
        assert factor.dtype == torch.float32
    v = torch.from_numpy(np.random.default_rng(0).standard_normal(kfac.shape[0]).astype(np.float32))
    assert bool(torch.isfinite((kfac @ v).float()).all())
    assert bool(torch.isfinite((kfac.inverse(damping=1e-1) @ v).float()).all())

    kfac2, *_ = _kfac_pair("type-2")
    assert all(f.dtype == torch.float32 for f in (*kfac2._aaT.values(), *kfac2._ggT.values()))
    model_fn, jparams, jdata = _jax_problem(jnp.bfloat16)
    J = cl.KFACLinearOperator(model_fn, cl.CrossEntropyLoss("mean"), jparams, jdata,
                              fisher_type="type-2", check_deterministic=False)
    for leaf in jax.tree.leaves((J._aaT, J._ggT)):
        assert leaf.dtype == jnp.float32
    ones = jax.tree.map(np.ones_like, jparams)
    expected = _as_port(jax.jit(J.matvec_tree)(ones), model)
    assert rel_fro(_flat(kfac2.matvec_tree(_ones(params))), _flat(expected)) < BF16_TOL


RECIPES = {
    "kfac": lambda k, make: k,
    "exact": lambda k, make: k.inverse(damping=1e-1, use_exact_damping=True),
    "heuristic": lambda k, make: k.inverse(damping=1e-1, use_heuristic_damping=True),
    "ekfac": lambda k, make: make(),
}


@pytest.mark.parametrize("recipe", sorted(RECIPES))
def test_bf16_kfac_family_matvec_preserves_param_dtype(recipe):
    """Each KFAC-family operator of the bfloat16 model (MC) maps a bfloat16
    matrix of ones ``[*p.shape, 1]`` to bfloat16, finite (as JAX's test);
    the type-2 build's output within 5e-2 of JAX's bfloat16 type-2 one."""
    outs = {}
    for fisher_type in ("mc", "type-2"):
        kfac, model, params, data = _kfac_pair(fisher_type)
        op = RECIPES[recipe](kfac, lambda: T.EKFACLinearOperator(
            model, T.CrossEntropyLoss("mean"), params, data, fisher_type=fisher_type,
            mc_samples=1, check_deterministic=False))
        M = _ones(params, cols=True)
        outs[fisher_type] = op @ M
        for leaf_in, leaf_out in zip(M.values(), outs[fisher_type].values()):
            assert leaf_out.dtype == leaf_in.dtype == torch.bfloat16
            assert bool(torch.isfinite(leaf_out.float()).all())

    model_fn, jparams, jdata = _jax_problem(jnp.bfloat16)
    kw = dict(fisher_type="type-2", check_deterministic=False)
    J = cl.KFACLinearOperator(model_fn, cl.CrossEntropyLoss("mean"), jparams, jdata, **kw)
    jop = RECIPES[recipe](J, lambda: cl.EKFACLinearOperator(
        model_fn, cl.CrossEntropyLoss("mean"), jparams, jdata, **kw))
    M = jax.tree.map(lambda p: np.ones(p.shape + (1,), p.dtype), jparams)
    expected = _as_port(jax.tree.map(lambda a: a[..., 0], jax.jit(lambda m: jop @ m)(M)), model)
    got = {n: t[..., 0] for n, t in outs["type-2"].items()}
    assert rel_fro(_flat(got), _flat(expected)) < BF16_TOL


def test_bf16_resnet_ggn_deviation_matches_jax():
    """Where bfloat16 loses more than 5e-2: the narrow ResNet (one basic
    block a stage, widths 16/16/32/32, BatchNorm calibrated on its 8 images
    of 32 x 32), its weights and images rounded to bfloat16 in both
    precisions. The port's bfloat16 GGN matvec of ones deviates from its
    float32 twin's by as much as the JAX package's bfloat16 matvec deviates
    from JAX's float32 one (their ratio within [0.8, 1.25]; both about a
    quarter: the bfloat16 forward moves the logits by a few per cent, and
    the softmax's Hessian magnifies that), and the two float32 matvecs agree
    to 1e-4 (float32, twenty layers)."""
    import copy

    from tests.test_torch_helpers import narrow_resnet

    case = narrow_resnet(seed=0, batch=8, hw=32, calib=8)
    jdtypes, ops, ones = (jnp.bfloat16, jnp.float32), [], []
    for jdtype in jdtypes:  # rounded in numpy: JAX's eager casts compile one program each
        p = jax.tree.map(lambda a: np.asarray(a).astype(jnp.bfloat16).astype(jdtype),
                         case["jax_params"])
        X = np.asarray(case["X_nhwc"]).astype(jnp.bfloat16).astype(jdtype)
        ops.append(cl.GGNLinearOperator(case["apply_fn"], cl.CrossEntropyLoss("mean"), p,
                                        [(X, case["y"])], check_deterministic=False))
        ones.append(jax.tree.map(np.ones_like, p))
    trees = jax.jit(lambda a, b: (ops[0].matvec_tree(a), ops[1].matvec_tree(b)))(*ones)
    out = {jdtype: _flat(_as_port(tree, case["model"])) for jdtype, tree in zip(jdtypes, trees)}
    bf16 = copy.deepcopy(case["model"]).to(torch.bfloat16)
    for model in (bf16, copy.deepcopy(bf16).float()):
        params = dict(model.named_parameters())
        X = case["X"].to(torch.bfloat16).to(next(model.parameters()).dtype)
        G = T.GGNLinearOperator(model, T.CrossEntropyLoss("mean"), params, [(X, case["y_t"])],
                                check_deterministic=False)
        out[next(model.parameters()).dtype] = _flat(G.matvec_tree(_ones(params)))
    port = rel_fro(out[torch.bfloat16], out[torch.float32])
    jax_dev = rel_fro(out[jnp.bfloat16], out[jnp.float32])
    assert rel_fro(out[torch.float32], out[jnp.float32]) < 1e-4
    assert jax_dev > BF16_TOL and 0.8 < port / jax_dev < 1.25, (port, jax_dev)
