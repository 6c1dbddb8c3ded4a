"""The port's empirical-risk machinery against the JAX package, on the CPU.

``risk.py``'s gradient, normalisation, data statistics, column chunking and
determinism rails (the MC Fisher is in ``test_torch_risk_mc.py``); the port's
dense oracles (``curvlinops_tpu_torch.examples``); the flash GPT's refusal
of forward mode and the einsum GPT's GGN against JAX's; the float64
parameter round trip; and the port's independence from JAX.
"""

from __future__ import annotations

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from curvlinops_tpu import examples as jexamples
from curvlinops_tpu.curvature.ggn import GGNLinearOperator as JGGN
from curvlinops_tpu.losses import CrossEntropyLoss as JCrossEntropyLoss
from curvlinops_tpu.models import gpt as jgpt
from curvlinops_tpu.risk import CurvatureLinearOperator as JCurvature
from curvlinops_tpu_torch import examples as texamples
from curvlinops_tpu_torch.curvature.ggn import GGNLinearOperator
from curvlinops_tpu_torch.losses import CrossEntropyLoss
from curvlinops_tpu_torch.models import gpt as tgpt
from curvlinops_tpu_torch.models.common import from_jax_params, to_jax_params
from curvlinops_tpu_torch.models.flash_attention import FORWARD_MODE_REFUSAL
from curvlinops_tpu_torch.models.mlp import init_mlp, mlp_apply, mnist_mlp, tiny_mlp_problem
from curvlinops_tpu_torch.models.resnet import ResNet, narrow_resnet_problem
from curvlinops_tpu_torch.risk import CurvatureLinearOperator
from tests.test_torch_curvature import (
    ATOL,
    OPERATORS,
    PORT,
    RTOL,
    jax_oracle,
    make_case,
    port_operator,
)
from tests.test_torch_gpt import GEOMETRY
from tests.test_torch_helpers import (
    assert_close,
    capped_torch_threads,
    jax_apply,
    jax_gpt_init,
    rel_fro,
)

_threads = capped_torch_threads()

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def mlp_ce():
    return make_case("mlp_ce_mean")


# ---------------------------------------------------------------------- #
# gradient, normalisation, data statistics, chunking
# ---------------------------------------------------------------------- #
def test_gradient_and_loss_matches_jax(mlp_ce):
    """``gradient_and_loss`` over three batches, the operator's and the dense
    oracle's, against ``curvlinops_tpu.examples.gradient_and_loss``."""
    j, t = mlp_ce["jax"], mlp_ce["torch"]
    grad_j, loss_j = jax.jit(  # one compiled program: op by op takes seconds
        lambda p: jexamples.gradient_and_loss(j["model_fn"], j["loss_fn"], p, j["data"])
    )(j["params"])
    A = port_operator("ggn", mlp_ce)
    for grad, loss in (
        A.gradient_and_loss(),
        texamples.gradient_and_loss(t["model"], t["loss_fn"], t["params"], t["data"]),
    ):
        assert_close(loss, np.asarray(loss_j), 1e-6, 1e-7, "loss")
        for layer in grad:
            for leaf in grad[layer]:
                assert_close(grad[layer][leaf], np.asarray(grad_j[layer][leaf]), RTOL, ATOL, leaf)


@pytest.mark.parametrize("reduction", ["mean", "sum"])
def test_uneven_batches_normalisation(reduction):
    """Batches of 5, 4 and 3 under ``mean`` (each weighted by its size over
    12) and ``sum``: the GGN and the Hessian against JAX's."""
    case = make_case(f"mlp_mse_{reduction}")
    for side in ("jax", "torch"):
        c = case[side]
        cat = jnp.concatenate if side == "jax" else torch.cat
        X = cat([X for X, _ in c["data"]])
        y = cat([y for _, y in c["data"]])
        c["data"] = [(X[a:b], y[a:b]) for a, b in ((0, 5), (5, 9), (9, 12))]
    for op in ("ggn", "hessian"):
        A = port_operator(op, case)
        assert A.num_data == 12
        assert_close(A @ torch.eye(A.shape[1]), jax_oracle(op, case), RTOL, ATOL, op)


class _NeedsTerms(CurvatureLinearOperator):
    NEEDS_NUM_PER_EXAMPLE_LOSS_TERMS = True


class _JNeedsTerms(JCurvature):
    NEEDS_NUM_PER_EXAMPLE_LOSS_TERMS = True


@pytest.mark.parametrize("case_name", ["seq_ce_mean", "mlp_bce_mean", "dict_mse"])
def test_data_statistics_inference(case_name):
    """``num_data`` (through ``batch_size_fn`` for dict inputs) and
    ``num_per_example_loss_terms`` inferred as the JAX package does."""
    case = make_case(case_name)
    j, t = case["jax"], case["torch"]
    ours = _NeedsTerms(t["model"], t["loss_fn"], t["params"], t["data"],
                       batch_size_fn=t["batch_size_fn"], check_deterministic=False)
    theirs = _JNeedsTerms(j["model_fn"], j["loss_fn"], j["params"], j["data"],
                          batch_size_fn=j["batch_size_fn"], check_deterministic=False)
    assert (ours.num_data, ours.num_per_example_loss_terms) == (
        theirs.num_data, theirs.num_per_example_loss_terms,
    )
    assert ours.num_per_example_loss_terms == (4 if case_name == "seq_ce_mean" else 1)


@pytest.mark.parametrize("op", OPERATORS)
def test_max_vmap_columns_chunking(op, mlp_ce):
    """Columns mapped 7 at a time give the product mapped all at once."""
    A = port_operator(op, mlp_ce, check_deterministic=False)
    chunked = port_operator(op, mlp_ce, check_deterministic=False, max_vmap_columns=7)
    M = torch.randn((A.shape[1], 17), generator=torch.Generator().manual_seed(0))
    assert_close(chunked @ M, A @ M, 1e-6, 1e-7, op)


def test_jacobian_prediction_space_formats(mlp_ce):
    """The Jacobians' prediction space takes and gives ``[N, C]`` tensors
    (with or without a column axis), and flat vectors as flat vectors."""
    J = port_operator("jacobian", mlp_ce)
    JT = J.adjoint()
    v = {k: {n: torch.randn_like(t) for n, t in layer.items()}
         for k, layer in mlp_ce["torch"]["params"].items()}
    Jv = J @ v
    assert Jv.shape == (12, 4)
    v_flat = torch.cat([t.reshape(-1) for layer in v.values() for t in layer.values()])
    assert_close(J @ v_flat, Jv.reshape(-1), 1e-6, 1e-7, "J flat")
    JTw = JT @ Jv
    assert isinstance(JTw, dict)
    JTw_flat = JT @ Jv.reshape(-1)
    assert JTw_flat.shape == (J.shape[1],)
    assert_close(torch.cat([t.reshape(-1) for layer in JTw.values() for t in layer.values()]),
                 JTw_flat, 1e-6, 1e-7, "J^T flat")
    assert (JT @ torch.stack([Jv, 2 * Jv], dim=-1))["layer0"]["W"].shape == (6, 7, 2)


# ---------------------------------------------------------------------- #
# determinism rails and argument validation
# ---------------------------------------------------------------------- #
class _Reshuffled:
    """A dataset whose every pass draws new inputs."""

    def __init__(self, data):
        self.data, self.passes = data, 0

    def __iter__(self):
        self.passes += 1
        gen = torch.Generator().manual_seed(self.passes)
        for X, y in self.data:
            yield torch.randn(X.shape, generator=gen), y


@pytest.mark.parametrize("op", ["ggn", "jacobian"])
def test_nondeterministic_data_raises(op, mlp_ce):
    case = {"torch": dict(mlp_ce["torch"], data=_Reshuffled(mlp_ce["torch"]["data"]))}
    with pytest.raises(RuntimeError, match="deterministic"):
        port_operator(op, case)


class _WatchedCE(CrossEntropyLoss):
    """Cross-entropy that records the targets it was called with."""

    seen: list = []

    def __call__(self, prediction, target):
        type(self).seen.append(target.clone())
        return super().__call__(prediction, target)


@pytest.mark.parametrize("bad", [4, -1], ids=["C", "negative"])
@pytest.mark.parametrize("batch", [0, 2])
def test_out_of_range_targets_raise_before_the_loss(bad, batch, mlp_ce):
    """A target outside ``[0, C)`` that is not ``ignore_index`` raises on the
    host before the loss of its batch is computed (on a GPU the loss's
    gather would be a device-side assert)."""
    t = mlp_ce["torch"]
    data = [(X, y.clone()) for X, y in t["data"]]
    data[batch][1][2] = bad
    _WatchedCE.seen = []
    with pytest.raises(ValueError, match="outside"):
        GGNLinearOperator(t["model"], _WatchedCE("mean"), t["params"], data)
    assert len(_WatchedCE.seen) == 2 * batch  # both passes' earlier batches
    assert not any((y == bad).any() for y in _WatchedCE.seen)


def test_unported_and_invalid_arguments_raise(mlp_ce):
    t = mlp_ce["torch"]
    args = (t["model"], t["loss_fn"], t["params"], t["data"])
    # a mesh is a DeviceMesh with the data axis (tests/test_torch_parallel.py)
    with pytest.raises(ValueError, match="no axis 'data'"):
        GGNLinearOperator(*args, mesh=object())
    GGNLinearOperator(*args, data_axis="data")  # the default axis, unused without a mesh
    with pytest.raises(ValueError, match="reduction"):
        GGNLinearOperator(t["model"], lambda f, y: f.sum(), t["params"], t["data"])
    with pytest.raises(ValueError, match="callable"):
        GGNLinearOperator(None, *args[1:])


# ---------------------------------------------------------------------- #
# the port's dense oracles, the MLP problem
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("op", ["ggn", "hessian", "ef", "jacobian"])
def test_examples_match_jax(op, mlp_ce):
    t = mlp_ce["torch"]
    args = (t["model"], t["loss_fn"], t["params"], t["data"])
    dense = {
        "ggn": lambda: texamples.dense_ggn(*args),
        "hessian": lambda: texamples.dense_hessian(*args),
        "ef": lambda: texamples.dense_empirical_fisher(*args),
        "jacobian": lambda: texamples.dense_jacobian(t["model"], t["params"], t["data"]),
    }[op]()
    assert_close(dense, jax_oracle(op, mlp_ce), RTOL, ATOL, op)


@pytest.mark.parametrize("case_name", ["mlp_mse_mean", "mlp_bce_mean"])
def test_dense_empirical_fisher_matches_jax(case_name):
    """The EF oracle's MSE and BCE branches against the JAX EF operator."""
    case = make_case(case_name)
    t = case["torch"]
    dense = texamples.dense_empirical_fisher(t["model"], t["loss_fn"], t["params"], t["data"])
    assert_close(dense, jax_oracle("ef", case), RTOL, ATOL, case_name)


def test_mnist_mlp_problem():
    """The MNIST MLP: the JAX package's sizes and ``mlp_apply`` on its
    parameter layout; it defaults to the card."""
    p = mnist_mlp(batch_size=4, device="cpu")
    X, y = p.data[0]
    assert X.shape == (4, 784) and y.shape == (4,)
    assert [tuple(p.params[f"dense{i}"]["W"].shape) for i in range(6)] == [
        (784, 1024), (1024, 512), (512, 256), (256, 128), (128, 64), (64, 10)
    ]
    assert p.model(p.params, X).shape == (4, 10)
    params = init_mlp(torch.Generator().manual_seed(0), sizes=(3, 2), device="cpu")
    W, b = params["dense0"]["W"], params["dense0"]["b"]
    assert torch.equal(mlp_apply(params, torch.eye(3)), W + b)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            mnist_mlp()


@pytest.mark.parametrize(
    "make, n_classes", [(narrow_resnet_problem, 10), (tiny_mlp_problem, 4)]
)
def test_card_test_problems(make, n_classes):
    """The float64 problems on which the card tests and ``chip_smoke.py``
    compare the card with the CPU: the same values on every build, logits
    of the class count, and the card by default."""
    p, again = make(device="cpu"), make(device="cpu")
    for (X, y), (X2, y2) in zip(p.data, again.data, strict=True):
        assert X.dtype == torch.float64 and torch.equal(X, X2) and torch.equal(y, y2)
        out = p.model(X) if isinstance(p.model, torch.nn.Module) else p.model(p.params, X)
        assert out.shape == (len(y), n_classes) and out.dtype == torch.float64
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make()


# ---------------------------------------------------------------------- #
# the GPT: forward-mode refusal on flash, GGN parity on einsum
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("op", ["ggn", "hessian", "ef"])
def test_flash_gpt_refuses_forward_mode(op):
    """On the flash GPT the forward-mode operators raise the refusal, at
    construction (the determinism probe's matvec) and at the first matvec."""
    op = PORT[op]
    p = tgpt.shakespeare_nanogpt(batch_size=2, config=tgpt.TINY_GPT, device="cpu",
                                 attention_impl="flash")
    args = (p.model, p.loss_fn, p.params, p.data)
    with pytest.raises(NotImplementedError) as err:
        op(*args)
    assert str(err.value) == FORWARD_MODE_REFUSAL
    assert "forward mode" in FORWARD_MODE_REFUSAL
    assert 'attention_impl="einsum"' in FORWARD_MODE_REFUSAL
    A = op(*args, check_deterministic=False)
    with pytest.raises(NotImplementedError, match="forward mode"):
        A @ torch.ones(A.shape[1])


def test_einsum_gpt_ggn_matches_jax():
    """The GGN of the einsum GPT (block 128, vocab 64, 2 layers, width 32,
    B=2, all parameters) against the JAX package's: relative Frobenius error
    of two matvecs below 1e-4 (float32 sums in another order)."""
    rng = np.random.default_rng(0)
    config = jgpt.GPTConfig(**GEOMETRY, attention_impl="einsum")
    params = jax.tree.map(
        lambda a: np.asarray(a) + 0.1 * rng.standard_normal(a.shape).astype(np.float32),
        jax_gpt_init(config),
    )
    tokens = rng.integers(0, GEOMETRY["vocab_size"], size=(2, GEOMETRY["block_size"] + 1))
    X, y = tokens[:, :-1], tokens[:, 1:].reshape(-1)
    fn = jax.tree_util.Partial(jgpt.gpt_apply, config=config)
    A_j = JGGN(fn, JCrossEntropyLoss("mean"), params, [(X, y)], check_deterministic=False)
    model = tgpt.GPT(tgpt.GPTConfig(**GEOMETRY, attention_impl="einsum"))
    model.load_state_dict(from_jax_params(params, model))
    A = GGNLinearOperator(model, CrossEntropyLoss("mean"), dict(model.named_parameters()),
                          [(torch.from_numpy(X), torch.from_numpy(y))])
    for k in range(2):
        v_j = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32), params)
        out_j = from_jax_params(jax_apply(A_j, v_j), model)
        v = from_jax_params(v_j, model)
        out = A @ {n: v[n] for n in A.in_spec}  # the operator's key order
        err = rel_fro(torch.cat([out[n].reshape(-1) for n in out]),
                      torch.cat([out_j[n].reshape(-1) for n in out]))
        assert err < 1e-4, f"column {k}: relative error {err}"


# ---------------------------------------------------------------------- #
# repairs and independence from JAX
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("op", ["ggn", "hessian", "ef", "jacobian", "jacobian_t", "gradient"])
def test_products_carry_no_autograd_graph(op):
    """On a partial parameter dict (KFAC's, BatchNorm left in the module),
    every product and the gradient come back without an autograd graph:
    the module's own parameters require gradients, and a solver's loop
    over products that recorded against them kept every iteration's graph
    alive (a fault of the port before the solvers' slice)."""
    problem = narrow_resnet_problem(device="cpu")
    assert len(problem.kfac_params) < len(problem.params)
    case = {"torch": dict(model=problem.model, loss_fn=problem.loss_fn,
                          params=problem.kfac_params, data=problem.data, batch_size_fn=None)}
    if op == "gradient":
        out = port_operator("ggn", case).gradient_and_loss()[0]
    else:
        A = port_operator(op, case)
        v = torch.randn(A.shape[1], generator=torch.Generator().manual_seed(0), dtype=torch.float64)
        out = {"out": A @ v}
    assert not any(t.requires_grad for t in out.values())


def test_to_jax_params_keeps_float64():
    """A float64 ``named`` dict round-trips bit for bit; bfloat16 becomes
    float32 (numpy has no bfloat16)."""
    model = ResNet("basic", (1, 1, 1, 1), (4, 4, 8, 8), 3, stem_width=4).double()
    gen = torch.Generator().manual_seed(0)
    named = {n: torch.randn(p.shape, generator=gen, dtype=torch.float64)
             for n, p in model.named_parameters()}
    tree = to_jax_params(named, model)
    assert {a.dtype for a in jax.tree.leaves(tree)} == {np.dtype(np.float64)}
    back = from_jax_params(tree, model)
    assert back.keys() == named.keys()
    for n in named:
        assert back[n].dtype == torch.float64 and torch.equal(back[n], named[n]), n
    bf16 = to_jax_params({n: t.to(torch.bfloat16) for n, t in named.items()}, model)
    assert {a.dtype for a in jax.tree.leaves(bf16)} == {np.dtype(np.float32)}


def test_port_imports_no_jax():
    """No module of the port, and not ``chip_smoke.py``, imports JAX or the
    JAX package."""
    pattern = re.compile(r"^\s*(import|from)\s+(jax|curvlinops_tpu)\b", re.M)
    files = sorted((REPO / "curvlinops_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    offenders = [str(f.relative_to(REPO)) for f in files if pattern.search(f.read_text())]
    assert len(files) > 20 and not offenders, offenders
