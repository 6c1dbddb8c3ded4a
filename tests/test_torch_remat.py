"""``remat_blocks`` on the stacked GPT and ViT under the curvature operators'
``torch.func`` transforms.

The stacked models rematerialise each block by default, as the JAX
package's ``lax.scan`` models wrap their block in ``jax.checkpoint``. Here:

- (a) parity: the port's stacked einsum GPT, flash GPT and ViT with remat
  against JAX's stacked models (which remat by default), same numpy inputs
  and ``from_jax_params`` weights: gradient and loss, the GGN, Hessian, EF
  and MC Fisher (``mc_samples=2``) matvecs, and on the einsum GPT the GGN
  diagonal (16 entries against JAX's GGN columns: JAX's diagonal operator
  maps one datum at a time and takes no GPT's flattened token rows; and
  remat against no remat in full) and the held GGN (``linearized()``); the
  flash GPT, reverse mode only, by its gradient and loss. Tolerances those of the stacked GPT in
  ``tests/test_torch_transformers.py``. JAX's oracles are built once per
  model, each as one ``jax.jit`` program;
- (b) remat against no remat, port against port, to 1e-6 relative;
- (c) how often each transform runs a block, counted by a forward hook on
  ``h.mlp_fc``;
- (d) ``gradcheck`` and ``gradgradcheck`` of the remat Function in float64,
  forward mode and batched gradients included, and the Hessian-vector
  product forward over reverse and reverse over reverse, float64;
- the refusal under ``torch.func.functionalize``.

The MC Fisher's samples come from ``torch.Generator`` (``risk.py``'s
``batch_generator``); JAX's oracle takes the port's samples and applies
``J^T (sum_k g_k g_k^T / rows) J`` through JAX's own Jacobians.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from curvlinops_tpu.losses import CrossEntropyLoss as JCrossEntropyLoss
from curvlinops_tpu.models import gpt as jgpt
from curvlinops_tpu.models import vit as jvit
from curvlinops_tpu_torch import (
    EFLinearOperator,
    GGNDiagonalLinearOperator,
    GGNLinearOperator,
    HessianLinearOperator,
)
from curvlinops_tpu_torch.curvature.loss_hessian import FisherType, make_grad_output_fn
from curvlinops_tpu_torch.losses import CrossEntropyLoss
from curvlinops_tpu_torch.models import gpt as tgpt
from curvlinops_tpu_torch.models import vit as tvit
from curvlinops_tpu_torch.models.common import from_jax_params, to_jax_params
from curvlinops_tpu_torch.models.stack import _RematBlock
from curvlinops_tpu_torch.risk import batch_generator
from tests.test_torch_gpt import GEOMETRY, MATVEC_TOL
from tests.test_torch_helpers import capped_torch_threads, rel_fro

_threads = capped_torch_threads()

BATCH = 2
MC, MC_SEED = 2, 7
REMAT_TOL = 1e-6  # remat against no remat, float32: the same ops in the same order
PRODUCTS = ("ggn", "hessian", "ef", "mc")
PORT_OPS = {
    "ggn": (GGNLinearOperator, {}),
    "hessian": (HessianLinearOperator, {}),
    "ef": (EFLinearOperator, {}),
    "mc": (GGNLinearOperator, {"mc_samples": MC, "seed": MC_SEED}),
}


def _noisy(params, seed=0):
    """JAX's initialisation plus seeded noise, so biases and norms are not trivial."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: np.asarray(a) + 0.1 * rng.standard_normal(a.shape).astype(np.float32), params
    )


def _flat(tree: dict, model) -> torch.Tensor:
    """``tree``'s tensors flattened in ``model``'s parameter order."""
    return torch.cat([tree[n].detach().reshape(-1) for n, _ in model.named_parameters()])


def _port_results(model, X, y, jvec, diagonal=False) -> dict:
    """Loss, gradient and each product's matvec of the port at ``jvec``
    (a JAX-tree vector), flattened in the model's parameter order; with
    ``diagonal`` also the GGN diagonal and, with remat, the held GGN's
    matvec (its ``make_fx`` trace is of forward mode alone, which runs each
    block once with or without remat)."""
    loss_fn = CrossEntropyLoss("mean")
    params, data = dict(model.named_parameters()), [(X, y)]
    v = from_jax_params(jvec, model)
    out = {}
    for name, (cls, kw) in PORT_OPS.items():
        A = cls(model, loss_fn, params, data, check_deterministic=False, **kw)
        out[name] = _flat(A @ {n: v[n] for n in A.in_spec}, model)
        if name == "ggn":
            grad, loss = A.gradient_and_loss()
            out["gradient"], out["loss"] = _flat(grad, model), loss.detach().reshape(1)
            if diagonal and model.remat_blocks:
                out["held_ggn"] = _flat(A.linearized() @ {n: v[n] for n in A.in_spec}, model)
    if diagonal:
        out["diagonal"] = _flat(GGNDiagonalLinearOperator(
            model, loss_fn, params, data, check_deterministic=False).diagonal, model)
    return out


def _port_samples(model, X, y) -> np.ndarray:
    """The MC Fisher's grad-output samples ``[rows, MC, C]`` of the port's
    operator on this batch (``batch_generator(MC_SEED, 0)``)."""
    with torch.no_grad():
        pred = model(X)
    G = make_grad_output_fn(CrossEntropyLoss("mean"), FisherType.MC, MC)(
        pred, y, batch_generator(MC_SEED, 0, torch.device("cpu")))
    return G.reshape(pred.shape[0], MC, -1).numpy()


def _jax_oracle(apply, params, X, y, vec, G, units) -> dict:
    """JAX's stacked model (``jax.checkpoint`` on its block) in one
    ``jax.jit`` program: the mean cross-entropy's loss and gradient, and at
    ``vec`` the GGN ``J^T H J``, the Hessian (``jvp`` of ``grad``), the
    empirical Fisher ``J^T (sum_r g_r g_r^T / R) J`` (``g_r`` the rows'
    logit gradients) and the MC Fisher on the port's samples ``G``, each
    through ``jax.jvp``/``jax.vjp`` of the model (``R`` rows, one batch);
    and the GGN's columns at the stacked unit vectors ``units``."""
    loss_fn = JCrossEntropyLoss("mean")

    def run(v, G):
        f = lambda p: apply(p, X)  # noqa: E731
        loss_of = lambda p: loss_fn(f(p), y)  # noqa: E731
        loss, grad = jax.value_and_grad(loss_of)(params)
        pred, pull = jax.vjp(f, params)
        R = pred.shape[0]
        logit_grad = jax.grad(lambda q: loss_fn(q, y))
        rows = jax.nn.softmax(pred, -1) - jax.nn.one_hot(y, pred.shape[-1])

        def ggnvp(u):
            jv = jax.jvp(f, (params,), (u,))[1]
            return pull(jax.jvp(logit_grad, (pred,), (jv,))[1])[0]

        jv = jax.jvp(f, (params,), (v,))[1]
        coeff = jnp.einsum("nkc,nc->nk", G, jv)
        out = dict(
            loss=loss, gradient=grad, ggn=ggnvp(v),
            hessian=jax.jvp(jax.grad(loss_of), (params,), (v,))[1],
            ef=pull(rows * jnp.sum(rows * jv, -1, keepdims=True) / R)[0],
            mc=pull(jnp.einsum("nkc,nk->nc", G, coeff) / R)[0],
        )
        if units is not None:
            out["columns"] = jax.vmap(ggnvp)(units)
        return out

    return jax.tree.map(np.asarray, jax.jit(run)(vec, G))


def _as_port(value, model) -> torch.Tensor:
    if isinstance(value, dict):
        return _flat(from_jax_params(value, model), model)
    return torch.from_numpy(np.atleast_1d(value))


def _case(make_model, apply, X_np, X, y_np, diagonal) -> dict:
    """The port with and without remat and JAX's oracle on one batch; the
    weights are the port's seeded initialisation plus seeded noise, as
    numpy, crossing to each model through ``from_jax_params``."""
    model = make_model(True)
    jparams = _noisy(to_jax_params({n: p.detach() for n, p in model.named_parameters()}, model))
    rng = np.random.default_rng(5)
    vec = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32), jparams)
    y = torch.from_numpy(y_np)
    port = {}
    for remat in (True, False):
        model = make_model(remat)
        model.load_state_dict(from_jax_params(jparams, model))
        port[remat] = _port_results(model, X, y, vec, diagonal)
    G = _port_samples(model, X, y)
    units = None
    if diagonal:  # JAX's GGN diagonal maps one datum at a time, not a GPT's rows
        flat = port[True]["diagonal"]
        idx = torch.from_numpy(np.random.default_rng(6).choice(flat.numel(), 16, replace=False))
        named = list(model.named_parameters())
        E = torch.zeros(len(idx), flat.numel())
        E[torch.arange(len(idx)), idx] = 1.0
        trees = [to_jax_params({n: t.reshape(p.shape) for (n, p), t in zip(
            named, e.split([p.numel() for _, p in named]))}, model) for e in E]
        units = jax.tree.map(lambda *a: np.stack(a), *trees)
    expected = _jax_oracle(apply, jparams, X_np, y_np, vec, G, units)
    columns = expected.pop("columns", None)
    expected = {k: _as_port(v, model) for k, v in expected.items()}
    expected["held_ggn"] = expected["ggn"]
    if diagonal:
        expected["diagonal_entries"] = torch.stack([
            _as_port(jax.tree.map(lambda a, k=k: a[k], columns), model)[i]
            for k, i in enumerate(idx)])
        for side in port.values():
            side["diagonal_entries"] = side["diagonal"][idx]
        port[False]["held_ggn"] = port[False]["ggn"]
    return {"remat": port[True], "plain": port[False], "jax": expected}


@pytest.fixture(scope="module")
def einsum_gpt():
    config = tgpt.TINY_GPT
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, config.vocab_size, size=(BATCH, config.block_size + 1))
    X, y = tokens[:, :-1], tokens[:, 1:].reshape(-1)
    jconfig = jgpt.GPTConfig(**config.__dict__)
    return _case(
        lambda remat: tgpt.GPT(config, True, remat),
        jax.tree_util.Partial(jgpt.gpt_apply, config=jconfig),
        X, torch.from_numpy(X), y, diagonal=True,
    )


@pytest.fixture(scope="module")
def vit():
    config = tvit.TINY_VIT
    rng = np.random.default_rng(4)
    X = rng.uniform(size=(BATCH, config.image_size, config.image_size, 3)).astype(np.float32)
    y = rng.integers(0, config.num_classes, size=BATCH)
    return _case(
        lambda remat: tvit.ViT(config, True, remat),
        jax.tree_util.Partial(jvit.vit_apply, config=jvit.ViTConfig(**config.__dict__)),
        X, torch.from_numpy(X).permute(0, 3, 1, 2).contiguous(), y, diagonal=False,
    )


@pytest.fixture(scope="module")
def flash_gpt():
    """The flash GPT at ``tests/test_torch_gpt.py``'s geometry (JAX's flash
    kernel needs ``T = 128``): gradient and loss. JAX's kernel runs in
    interpret mode as one ``jax.jit`` call; there its ordered I/O effects
    are refused inside ``jax.checkpoint``, so JAX's oracle applies its
    stacked blocks with ``remat_blocks=False`` (the same function)."""
    config = tgpt.GPTConfig(**GEOMETRY, attention_impl="flash")
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, config.vocab_size, size=(BATCH, config.block_size + 1))
    X, y = tokens[:, :-1], tokens[:, 1:].reshape(-1)
    model = tgpt.GPT(config, True)
    params = _noisy(to_jax_params({n: p.detach() for n, p in model.named_parameters()}, model))
    loss_fn = JCrossEntropyLoss("mean")
    apply = functools.partial(jgpt.gpt_apply, config=jgpt.GPTConfig(**config.__dict__),
                              remat_blocks=False)
    with pltpu.force_tpu_interpret_mode():
        loss, grad = jax.block_until_ready(jax.jit(jax.value_and_grad(
            lambda p: loss_fn(apply(p, X), y)))(params))
    out = {}
    for remat in (True, False):
        model = tgpt.GPT(config, True, remat)
        model.load_state_dict(from_jax_params(params, model))
        A = GGNLinearOperator(model, CrossEntropyLoss("mean"), dict(model.named_parameters()),
                              [(torch.from_numpy(X), torch.from_numpy(y))],
                              check_deterministic=False)
        g, value = A.gradient_and_loss()
        out[remat] = {"gradient": _flat(g, model), "loss": value.detach().reshape(1)}
    expected = {"gradient": _as_port(grad, model), "loss": _as_port(loss, model)}
    return {"remat": out[True], "plain": out[False], "jax": expected}


EINSUM_ITEMS = ("gradient", "loss", *PRODUCTS, "diagonal_entries", "held_ggn")
VIT_ITEMS = ("gradient", "loss", *PRODUCTS)


@pytest.mark.parametrize("item", EINSUM_ITEMS)
def test_einsum_gpt_remat_matches_jax(einsum_gpt, item):
    """(a) and (b) on the stacked einsum GPT."""
    assert rel_fro(einsum_gpt["remat"][item], einsum_gpt["jax"][item]) < MATVEC_TOL, item
    assert rel_fro(einsum_gpt["remat"][item], einsum_gpt["plain"][item]) <= REMAT_TOL, item


@pytest.mark.parametrize("item", VIT_ITEMS)
def test_vit_remat_matches_jax(vit, item):
    """(a) and (b) on the stacked ViT."""
    assert rel_fro(vit["remat"][item], vit["jax"][item]) < MATVEC_TOL, item
    assert rel_fro(vit["remat"][item], vit["plain"][item]) <= REMAT_TOL, item


@pytest.mark.parametrize("item", ("gradient", "loss"))
def test_flash_gpt_remat_matches_jax(flash_gpt, item):
    """(a) and (b) on the stacked flash GPT (reverse mode only)."""
    assert rel_fro(flash_gpt["remat"][item], flash_gpt["jax"][item]) < MATVEC_TOL, item
    assert rel_fro(flash_gpt["remat"][item], flash_gpt["plain"][item]) <= REMAT_TOL, item


# ---------------------------------------------------------------------- #
# (c) recompute counts
# ---------------------------------------------------------------------- #
L = tgpt.TINY_GPT.n_layer


def _counted_calls(remat: bool, transform: str) -> int:
    problem = tgpt.shakespeare_nanogpt(batch_size=BATCH, config=tgpt.TINY_GPT, device="cpu",
                                       scan_blocks=True, remat_blocks=remat)
    model, (X, y) = problem.model, problem.data[0]
    params = {n: p.detach() for n, p in model.named_parameters()}
    gen = torch.Generator().manual_seed(0)
    v = {n: torch.randn(p.shape, generator=gen) for n, p in params.items()}

    def f(p):
        return torch.func.functional_call(model, p, (X,))

    def loss(p):
        return problem.loss_fn(f(p), y)

    run = {
        "grad": lambda: torch.func.grad(loss)(params),
        "vjp": lambda: torch.func.vjp(f, params)[1](torch.ones(X.numel(), 32)),
        "jvp": lambda: torch.func.jvp(f, (params,), (v,)),
        "vmap_vjp": lambda: torch.func.vmap(torch.func.vjp(f, params)[1])(
            torch.ones(3, X.numel(), 32)),
        "jvp_of_grad": lambda: torch.func.jvp(torch.func.grad(loss), (params,), (v,)),
        "grad_of_grad": lambda: torch.func.grad(lambda p: sum(
            (g * v[n]).sum() for n, g in torch.func.grad(loss)(p).items()))(params),
    }[transform]
    calls = [0]
    handle = model.h.mlp_fc.register_forward_hook(lambda *_: calls.__setitem__(0, calls[0] + 1))
    run()
    handle.remove()
    return calls[0]


@pytest.mark.parametrize("transform, with_remat, without", [
    ("grad", 2 * L, L),
    ("vjp", 2 * L, L),
    ("jvp", L, L),
    ("vmap_vjp", 2 * L, L),
    ("jvp_of_grad", 3 * L, L),
    ("grad_of_grad", 3 * L, L),
])
def test_remat_recomputes_under_each_transform(transform, with_remat, without):
    """Block calls (``h.mlp_fc``'s forward hook) with and without remat.

    - ``grad``, ``vjp`` and a ``vmap`` over a ``vjp``'s pullback: L in the
      forward, which keeps only the block inputs, and L more when the
      pullback recomputes each block (once for all the vmapped cotangents:
      the recompute reads no batched tensor);
    - ``jvp`` alone: L. No reverse mode records, so the loop runs each block
      once, as ``jax.checkpoint``'s forward-mode rule does;
    - ``jvp`` of ``grad`` (the Hessian): 3L. The forward under the outer
      ``jvp`` runs each block once for the primal and once more, inside the
      Function's ``jvp`` rule, for its tangent (a ``torch.autograd.Function``
      computes the two apart); the pullback recomputes it a third time, in
      forward mode too;
    - ``grad`` of ``grad`` (reverse over reverse): 3L. The inner ``grad``'s
      Function applies a Function at the outer level as well; the inner
      pullback recomputes each block once (recorded at the outer level), and
      the outer pullback recomputes it once more.
    """
    assert _counted_calls(True, transform) == with_remat
    assert _counted_calls(False, transform) == without


# ---------------------------------------------------------------------- #
# (d) the Function under gradcheck, and the functionalize refusal
# ---------------------------------------------------------------------- #
def _function_inputs():
    block = tgpt.Block(4, 1, "einsum", stack=2).double()
    names = tuple(n for n, _ in block.named_parameters())
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(1, 3, 4, dtype=torch.float64, generator=gen, requires_grad=True)
    slices = tuple(
        (p[1].detach() + 0.1 * torch.randn(p[1].shape, dtype=torch.float64, generator=gen))
        .requires_grad_()
        for _, p in block.named_parameters()
    )
    return (lambda x, *s: _RematBlock.apply(block, names, x, *s)), (x, *slices)


@pytest.mark.parametrize("check", ["gradcheck", "gradgradcheck"])
def test_remat_function_gradcheck(check):
    """First and second derivatives of one rematerialised block (a 4-wide
    block; ``fast_mode``, random projections of the Jacobians), with forward
    mode (plain ``torch.autograd.forward_ad``, and forward over reverse) and
    batched gradients."""
    fn, inputs = _function_inputs()
    if check == "gradcheck":
        assert torch.autograd.gradcheck(fn, inputs, check_forward_ad=True,
                                        check_batched_grad=True, fast_mode=True)
    else:
        assert torch.autograd.gradgradcheck(fn, inputs, check_fwd_over_rev=True,
                                            check_batched_grad=True, fast_mode=True)


@pytest.mark.parametrize("outer", ["jvp", "grad"])
def test_remat_hessian_vector_product_float64(outer):
    """The Hessian-vector product of the stacked GPT's loss, forward over
    reverse (``jvp`` of ``grad``) and reverse over reverse (``grad`` of the
    gradient's inner product with ``v``), with remat against without, float64."""
    out = {}
    for remat in (True, False):
        problem = tgpt.shakespeare_nanogpt(batch_size=BATCH, config=tgpt.TINY_GPT,
                                           dtype=torch.float64, device="cpu",
                                           scan_blocks=True, remat_blocks=remat)
        model, (X, y) = problem.model, problem.data[0]
        params = {n: p.detach() for n, p in model.named_parameters()}
        gen = torch.Generator().manual_seed(1)
        v = {n: torch.randn(p.shape, generator=gen, dtype=torch.float64)
             for n, p in params.items()}
        grad = torch.func.grad(
            lambda p: problem.loss_fn(torch.func.functional_call(model, p, (X,)), y))
        if outer == "jvp":
            hv = torch.func.jvp(grad, (params,), (v,))[1]
        else:
            hv = torch.func.grad(lambda p: sum((g * v[n]).sum() for n, g in grad(p).items()))(
                params)
        out[remat] = _flat(hv, model)
    assert rel_fro(out[True], out[False]) < 1e-12


def test_remat_refuses_functionalize():
    """``torch.func.functionalize`` cannot run the remat Function: the loop
    raises, naming the way out, and never runs the blocks without remat."""
    problem = tgpt.shakespeare_nanogpt(batch_size=BATCH, config=tgpt.TINY_GPT, device="cpu",
                                       scan_blocks=True)
    X, _ = problem.data[0]
    with pytest.raises(RuntimeError, match="functionalize.*remat_blocks=False"):
        torch.func.functionalize(problem.model)(X)
    problem.model.remat_blocks = False
    assert torch.isfinite(torch.func.functionalize(problem.model)(X)).all()
