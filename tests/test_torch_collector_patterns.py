"""The port's collector on function-level dense uses and bias adds.

The torch twins of ``tests/test_collector_patterns.py``: each builds the
JAX test's model in both packages, and the port's collector must accept
(with the same layer structure) or refuse (``ValueError``) where the JAX
collector does. The JAX test's NCHW conv cases map to torch's native NCHW
layout, its NHWC ones to NCHW with the bias broadcast onto the channel axis.
Function-level dense uses (``F.linear``, ``mm``, ``addmm``, ``x @ W.T``, a
tensor-valued weight through a view) are exact against the port's dense
block-diagonal GGN in float64; ambiguous uses raise.

HuggingFace's torch ``GPT2LMHeadModel`` stores its dense weights as
``Conv1D`` (``[in, out]``, ``addmm`` on ``x.view(-1, in)``): with the
weights of ``FlaxGPT2LMHeadModel(cfg, seed=0)`` (Flax kernels ``[out, in]``,
transposed) its KFAC over ``c_attn``/``c_proj``/``c_fc`` has the JAX
operator's 8 groups, factors and matvec (``tests/test_models.py``'s
``test_kfac_on_huggingface_flax_gpt2``, type-2 so that both are
deterministic).
"""

import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn

from curvlinops_tpu.kfac.collector import TracedModel as JTracedModel
from curvlinops_tpu.kfac.operator import KFACLinearOperator as JKFAC
from curvlinops_tpu.losses import CrossEntropyLoss as JCrossEntropyLoss
from curvlinops_tpu.losses import MSELoss as JMSELoss
from curvlinops_tpu_torch.kfac.collector import TracedModel
from curvlinops_tpu_torch.kfac.ekfac import EKFACLinearOperator
from curvlinops_tpu_torch.kfac.kfoc import KFOCLinearOperator
from curvlinops_tpu_torch.kfac.operator import KFACLinearOperator
from curvlinops_tpu_torch.losses import CrossEntropyLoss, MSELoss
from curvlinops_tpu_torch.models.stack import StackedLinear, scan
from tests.test_torch_helpers import blockdiag_ggn, capped_torch_threads, jax_apply, rel_fro

_threads = capped_torch_threads()

RTOL = 1e-10  # float64 against the dense GGN
HF_TOL = 1e-5  # float32 against the JAX operator


class Fn(nn.Module):
    """``fn(self, x)`` over the parameters ``params`` (numpy, by name)."""

    def __init__(self, fn, dtype=torch.float32, **params):
        super().__init__()
        self.fn = fn
        for k, v in params.items():
            setattr(self, k, nn.Parameter(torch.as_tensor(np.asarray(v), dtype=dtype)))

    def forward(self, x):  # noqa: D102
        return self.fn(self, x)


def _traced(model, x_shape) -> TracedModel:
    return TracedModel(model, dict(model.named_parameters()), torch.zeros(x_shape))


def _jax_traced(f, params, x_shape):
    return JTracedModel(f, jax.tree.map(jnp.asarray, params), jnp.zeros(x_shape))


def _refused_by_both(model, x_shape, f, params, match):
    with pytest.raises(ValueError, match=match):
        _traced(model, x_shape)
    with pytest.raises(ValueError):
        _jax_traced(f, params, x_shape)


# ---------------------------------------------------------------------- #
# twins of tests/test_collector_patterns.py
# ---------------------------------------------------------------------- #
def test_reshape_altering_last_dim_breaks_bias_pairing():
    """``x@W -> reshape(B, 2, 2) -> +b(2,)``: ``b`` is not the layer's bias."""
    params = {"W": np.zeros((6, 4)), "b": np.zeros(2)}

    def f(p, x):
        return (x @ p["W"]).reshape(x.shape[0], 2, 2) + p["b"]

    model = Fn(lambda m, x: (x @ m.W).reshape(x.shape[0], 2, 2) + m.b, **params)
    _refused_by_both(model, (3, 6), f, params, "transformed output")


def test_view_after_linear_not_absorbed():
    """A last-dim-preserving view after the layer leaves it intact."""
    params = {"W": np.zeros((3, 4)), "b": np.zeros(4)}
    model = Fn(lambda m, x: (x @ m.W + m.b).reshape(x.shape[0], 1, 4), **params)
    (u,) = _traced(model, (2, 3)).layers
    assert (u.kind, u.bias_path, u.meta["d_out"]) == ("dense", "b", 4)
    (ju,) = _jax_traced(lambda p, x: (x @ p["W"] + p["b"]).reshape(x.shape[0], 1, 4),
                        params, (2, 3)).layers
    assert ju.bias_path is not None and ju.meta["d_out"] == 4


def test_positional_bias_refused():
    """A ``(S,)`` leaf broadcast over the sequence axis is not a bias."""
    params = {"W": np.zeros((3, 4)), "b": np.zeros(5)}

    def f(p, x):
        return jnp.einsum("bsd,df->bsf", x, p["W"]) + p["b"][None, :, None]

    model = Fn(lambda m, x: x @ m.W + m.b[None, :, None], **params)
    _refused_by_both(model, (2, 5, 3), f, params, "cannot be the bias")


def test_weight_also_reduced_into_bias_refused():
    """``x@W + W.sum(0)``: the second read is not a layer."""
    params = {"W": np.zeros((3, 4))}
    model = Fn(lambda m, x: x @ m.W + m.W.sum(0), **params)
    _refused_by_both(model, (2, 3), lambda p, x: x @ p["W"] + p["W"].sum(0), params,
                     r"read outside its layer calls by \['sum'\]")


def test_transposed_weight_supported_and_exact():
    """``x @ W.T + b`` is a dense layer through its view: exact against the
    dense GGN, and equal to the JAX package's KFAC."""
    rng = np.random.default_rng(7)
    params = {"W": rng.standard_normal((4, 3)) / 2, "b": 0.1 * rng.standard_normal(4)}
    X, y = rng.standard_normal((1, 3)), rng.standard_normal((1, 4))
    model = Fn(lambda m, x: x @ m.W.T + m.b, dtype=torch.float64, **params)
    tparams = dict(model.named_parameters())
    data = [(torch.from_numpy(X), torch.from_numpy(y))]
    kfac = KFACLinearOperator(model, MSELoss("mean"), tparams, data, fisher_type="type-2")
    (u,) = kfac.groups[0].uses
    assert u.meta["w_views"] == (("permute", (1, 0), (4, 3)),)
    expected = blockdiag_ggn(model, MSELoss("mean"), tparams, data, kfac.groups)
    assert rel_fro(kfac.todense(), expected) < RTOL
    jkfac = JKFAC(lambda p, x: x @ p["W"].T + p["b"], JMSELoss("mean"),
                  jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), params),
                  [(jnp.asarray(X, jnp.float32), jnp.asarray(y, jnp.float32))],
                  fisher_type="type-2", check_deterministic=False)
    assert rel_fro(kfac.todense(), np.asarray(jkfac.todense())) < HF_TOL


def test_multiple_uses_recorded():
    """Reusing one weight gives two uses; the bias pairs with the first."""
    params = {"W": np.zeros((3, 3)), "b": np.zeros(3)}

    def fn(m, x):
        return (x @ m.W + m.b) @ m.W

    layers = _traced(Fn(fn, **params), (2, 3)).layers
    assert [u.bias_path for u in layers] == ["b", None]
    jlayers = _jax_traced(lambda p, x: (x @ p["W"] + p["b"]) @ p["W"], params, (2, 3)).layers
    assert [u.bias_path is not None for u in jlayers] == [True, False]


class ConvPlusBias(nn.Module):
    """A bias-free conv (NCHW) plus a separate ``b`` leaf broadcast as
    ``view`` shapes it."""

    def __init__(self, c_out: int, b_shape: tuple, view: tuple | None):
        super().__init__()
        self.conv = nn.Conv2d(3, c_out, 3, padding="same", bias=False)
        self.b = nn.Parameter(torch.zeros(b_shape))
        self.view = view

    def forward(self, x):  # noqa: D102
        return self.conv(x) + (self.b if self.view is None else self.b.view(self.view))


def _jax_conv(layout: str):
    spec = ("NHWC", "HWIO", "NHWC") if layout == "NHWC" else ("NCHW", "OIHW", "NCHW")

    def f(p, x):
        z = jax.lax.conv_general_dilated(x, p["W"], (1, 1), "SAME", dimension_numbers=spec)
        return z + (p["b"] if "b" in p else p["pos"])

    return f


def test_conv_bias_wrong_channel_count_refused():
    """Conv + a bias whose size is not the out-channel count."""
    _refused_by_both(ConvPlusBias(5, (1, 1, 1), None), (2, 3, 8, 8), _jax_conv("NHWC"),
                     {"W": np.zeros((3, 3, 3, 5)), "b": np.zeros((1, 1, 1))},
                     "cannot be the bias")
    with pytest.raises(ValueError):  # the JAX NHWC shape, as it is refused there
        _jax_traced(_jax_conv("NHWC"), {"W": np.zeros((3, 3, 3, 5)), "b": np.zeros((1, 1, 1))},
                    (2, 8, 8, 3))


def test_conv_bias_correct_channel_count_ok():
    """The channel bias ``(C, 1, 1)`` onto an NCHW conv output (the JAX
    test's NHWC ``(C,)`` bias) pairs as the conv's bias."""
    (u,) = _traced(ConvPlusBias(5, (5,), (5, 1, 1)), (2, 3, 8, 8)).layers
    assert (u.kind, u.bias_path) == ("conv", "b")
    (ju,) = _jax_traced(_jax_conv("NHWC"), {"W": np.zeros((3, 3, 3, 5)), "b": np.zeros(5)},
                        (2, 8, 8, 3)).layers
    assert ju.kind == "conv" and ju.bias_path is not None


def test_bias_tied_across_different_layers_refused():
    """One bias on two layers of different weights would duplicate its block."""
    params = {"W1": np.zeros((4, 4)), "W2": np.zeros((4, 4)), "b": np.zeros(4)}

    def fn(m, x):
        return torch.tanh(x @ m.W1 + m.b) @ m.W2 + m.b

    def f(p, x):
        return jnp.tanh(x @ p["W1"] + p["b"]) @ p["W2"] + p["b"]

    _refused_by_both(Fn(fn, **params), (3, 4), f, params, "tied across different layers")


def test_reversed_bias_refused():
    """``x@W + b`` reversed (``flip``, a copy in torch) silently permutes the
    bias block: refused."""
    params = {"W": np.zeros((4, 5)), "b": np.zeros(5)}
    _refused_by_both(Fn(lambda m, x: x @ m.W + m.b.flip(0), **params), (3, 4),
                     lambda p, x: x @ p["W"] + p["b"][::-1], params, "flip")


def test_position_broadcast_masquerading_as_bias_refused():
    """A ``(S,)`` leaf broadcast along the sequence axis with ``S == d_out``
    passes the size check but is not a per-feature bias."""
    params = {"W": np.zeros((5, 4)), "pos": np.zeros(4)}
    _refused_by_both(Fn(lambda m, x: x @ m.W + m.pos[None, :, None], **params), (2, 4, 5),
                     lambda p, x: x @ p["W"] + p["pos"][None, :, None], params,
                     "output-feature axis")


def test_normal_seq_bias_still_accepted():
    """The standard ``[B, S, d] + b(d,)`` broadcast pairs as the bias."""
    params = {"W": np.zeros((5, 4)), "b": np.zeros(4)}
    (u,) = _traced(Fn(lambda m, x: x @ m.W + m.b, **params), (2, 6, 5)).layers
    assert u.bias_path == "b"
    (ju,) = _jax_traced(lambda p, x: x @ p["W"] + p["b"], params, (2, 6, 5)).layers
    assert ju.bias_path is not None


class ScanThenBias(nn.Module):
    def __init__(self):
        super().__init__()
        self.stack = StackedLinear(2, 4, 4, bias=False)
        self.b = nn.Parameter(torch.zeros(4))

    def forward(self, x):  # noqa: D102
        h = scan(lambda h, l: torch.tanh(self.stack(h, l)), x, 2)
        return torch.relu(h) + self.b


def test_bias_on_transformed_scan_output_refused():
    """``relu(scan(...)) + b`` refuses like its unrolled equivalent."""

    def f(p, x):
        def body(h, W):
            return jnp.tanh(h @ W), None

        h, _ = jax.lax.scan(body, x, p["Ws"])
        return jax.nn.relu(h) + p["b"]

    _refused_by_both(ScanThenBias(), (3, 4), f, {"Ws": np.zeros((2, 4, 4)), "b": np.zeros(4)},
                     "transformed output")


def test_nchw_conv_spatial_broadcast_not_bias():
    """NCHW conv with ``W_out == C_out``: a ``(C,)`` leaf broadcast along the
    width axis is refused (only axis 1 is the channel axis)."""
    _refused_by_both(ConvPlusBias(6, (6,), None), (2, 3, 6, 6), _jax_conv("NCHW"),
                     {"W": np.zeros((6, 3, 3, 3)), "pos": np.zeros(6)}, "output-feature axis")


def test_nchw_conv_channel_bias_accepted():
    """The NCHW channel bias ``b[None, :, None, None]`` stays accepted."""
    (u,) = _traced(ConvPlusBias(5, (5,), (1, 5, 1, 1)), (2, 3, 6, 6)).layers
    assert (u.kind, u.bias_path) == ("conv", "b")

    def f(p, x):
        z = jax.lax.conv_general_dilated(x, p["W"], (1, 1), "SAME",
                                         dimension_numbers=("NCHW", "OIHW", "NCHW"))
        return z + p["b"][None, :, None, None]

    (ju,) = _jax_traced(f, {"W": np.zeros((5, 3, 3, 3)), "b": np.zeros(5)}, (2, 3, 6, 6)).layers
    assert ju.bias_path is not None


# ---------------------------------------------------------------------- #
# function-level dense uses: exact, or refused when ambiguous
# ---------------------------------------------------------------------- #
DENSE_USES = {  # (parameters, forward) of a two-layer deep linear model
    "linear_fn": ({"W1": (3, 4), "b1": (3,), "W2": (2, 3)},
                  lambda m, x: F.linear(F.linear(x, m.W1, m.b1), m.W2)),
    "mm_T": ({"W1": (3, 4), "W2": (3, 2)},
             lambda m, x: torch.mm(x @ m.W1.T, m.W2)),
    "addmm": ({"W1": (4, 3), "b1": (3,), "W2": (3, 2), "b2": (2,)},
              lambda m, x: torch.addmm(m.b2, torch.addmm(m.b1, x, m.W1), m.W2)),
    "tensor_valued": ({"W1": (2, 2, 3), "W2": (3, 2)},
                      lambda m, x: (x @ m.W1.reshape(4, 3)) @ m.W2),
    "permuted_3d": ({"W1": (3, 2, 2), "W2": (2, 3)},
                    lambda m, x: (x @ m.W1.permute(1, 2, 0).reshape(4, 3)) @ m.W2.T),
}


@pytest.mark.parametrize("approx", ["expand", "reduce"])
@pytest.mark.parametrize("use", list(DENSE_USES))
def test_function_dense_uses_exact(use, approx):
    """Deep linear models whose weights reach ``F.linear``, ``mm``,
    ``addmm`` or ``@`` through transposes, reshapes and permutes: KFAC
    (EXPAND over a sequence axis, REDUCE after a mean over it) equals the
    block-diagonal GGN, and ``P (P^T v) = v``."""
    shapes, fn = DENSE_USES[use]
    rng = np.random.default_rng(11)
    params = {k: 0.5 * rng.standard_normal(s) for k, s in shapes.items()}
    reduce = approx == "reduce"

    def body(m, x):
        out = fn(m, x.reshape(-1, 4)).reshape(x.shape[0], x.shape[1], 2)
        return out.mean(dim=1) if reduce else out

    model = Fn(body, dtype=torch.float64, **params)
    X = torch.from_numpy(rng.standard_normal((3, 5, 4)))
    y = torch.from_numpy(rng.standard_normal((3, 2) if reduce else (3, 5, 2)))
    tparams = dict(model.named_parameters())
    kfac = KFACLinearOperator(model, MSELoss("sum"), tparams, [(X, y)], fisher_type="type-2",
                              kfac_approx=approx)
    assert all(u.meta["merged_rows"] and u.meta["batch_major"]
               for g in kfac.groups for u in g.uses if g.weight_path)
    expected = blockdiag_ggn(model, MSELoss("sum"), tparams, [(X, y)], kfac.groups)
    assert rel_fro(kfac.todense(), expected) < RTOL
    v = {k: torch.randn_like(p) for k, p in tparams.items()}
    P, PT = kfac._from_canonical, kfac._to_canonical
    back = P(PT(v))
    assert all(torch.equal(back[k], v[k]) for k in v)


def _ambiguous(mode):
    W = np.zeros((4, 4))
    if mode == "left_operand":
        return Fn(lambda m, x: (m.W @ x.T).T, W=W)
    if mode == "batch_contracted":
        return Fn(lambda m, x: (x.sum(0) @ m.W).expand(x.shape[0], 4), W=W)
    if mode == "tied_transposed":
        return Fn(lambda m, x: x @ m.W + x @ m.W.T, W=W)
    if mode == "conflicting_add":
        return Fn(lambda m, x: torch.addmm(m.b, x, m.W) + m.c, W=W, b=np.zeros(4), c=np.zeros(4))
    raise ValueError(mode)


@pytest.mark.parametrize(
    "mode, match",
    [("left_operand", r"\['matmul'\]"), ("batch_contracted", "batch axis"),
     ("tied_transposed", "contract different axes"), ("conflicting_add", "conflicting biases")],
)
def test_ambiguous_dense_uses_refused(mode, match):
    """The weight as the left operand, a contraction over the batch axis, one
    weight contracted along different axes, and a second bias on an
    ``addmm`` that has one are refused."""
    model = _ambiguous(mode)
    X = torch.zeros(3, 4)
    with pytest.raises(ValueError, match=match):
        KFACLinearOperator(model, MSELoss("sum"), dict(model.named_parameters()),
                           [(X, torch.zeros(3, 4))], fisher_type="type-2")


class MergedRows(nn.Module):
    """``addmm`` on the rows of ``[B, T, 4]``: a view of the input (proven
    batch-major), or the rows of its time-major copy (not proven)."""

    def __init__(self, time_major: bool):
        super().__init__()
        self.W = nn.Parameter(torch.randn(4, 2, dtype=torch.float64,
                                          generator=torch.Generator().manual_seed(0)))
        self.b = nn.Parameter(torch.zeros(2, dtype=torch.float64))
        self.time_major = time_major

    def forward(self, x):  # noqa: D102
        B, T = x.shape[:2]
        if self.time_major:  # rows ordered (t, b), then put back
            rows = x.transpose(0, 1).reshape(-1, 4)
            return torch.addmm(self.b, rows, self.W).reshape(T, B, 2).transpose(0, 1)
        return torch.addmm(self.b, x.view(-1, 4), self.W).view(B, T, 2)


@pytest.mark.parametrize("time_major", [False, True], ids=["batch_major", "time_major"])
def test_merged_rows(time_major):
    """Rows of ``B * T`` merge the batch axis: EXPAND regroups them as
    ``[B, T, d]`` and is exact either way; REDUCE, EKFAC and KFOC need them
    grouped by datum and refuse rows not proven batch-major, naming the use."""
    rng = np.random.default_rng(12)
    model = MergedRows(time_major)
    X = torch.from_numpy(rng.standard_normal((3, 5, 4)))
    data = [(X, torch.from_numpy(rng.standard_normal((3, 5, 2))))]
    params = dict(model.named_parameters())
    kfac = KFACLinearOperator(model, MSELoss("sum"), params, data, fisher_type="type-2")
    assert rel_fro(kfac.todense(),
                   blockdiag_ggn(model, MSELoss("sum"), params, data, kfac.groups)) < RTOL
    builds = [
        lambda: KFACLinearOperator(model, MSELoss("sum"), params, data, fisher_type="type-2",
                                   kfac_approx="reduce"),
        lambda: EKFACLinearOperator(
            nn.Sequential(model, nn.Flatten()), MSELoss("sum"),
            {f"0.{k}": v for k, v in params.items()}, [(X, y.flatten(1)) for X, y in data],
            fisher_type="type-2"),
        lambda: KFOCLinearOperator(model, MSELoss("sum"), params, data, fisher_type="type-2"),
    ]
    for build in builds:
        if time_major:
            with pytest.raises(ValueError, match="W:addmm"):
                build()
        else:
            build()


# ---------------------------------------------------------------------- #
# HuggingFace GPT-2: Conv1D weights [in, out] against the Flax twin
# ---------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def hf_gpt2():
    """The torch and Flax HuggingFace GPT-2 (1 layer, width 16, vocab 64) on
    the Flax model's seed-0 weights, and both packages' KFAC over the
    ``Conv1D`` weights and biases, built once."""
    before = os.environ.get("USE_TF")
    os.environ["USE_TF"] = "0"  # the torch and Flax models only
    try:
        transformers = pytest.importorskip("transformers")
    finally:
        if before is None:
            os.environ.pop("USE_TF")
        else:
            os.environ["USE_TF"] = before
    import jax.tree_util as jtu

    from curvlinops_tpu.utils.misc import FrozenModelFn

    cfg = transformers.GPT2Config(n_layer=1, n_head=2, n_embd=16, vocab_size=64, n_positions=16)
    # FlaxGPT2LMHeadModel(cfg, seed=0)'s weights, initialised as one
    # compiled program (its eager initialisation takes seconds)
    flax_model = transformers.FlaxGPT2LMHeadModel(cfg, _do_init=False)
    flax_params = jax.jit(flax_model.init_weights, static_argnums=1)(jax.random.PRNGKey(0), (1, 1))
    hf = transformers.GPT2LMHeadModel(cfg).eval()
    flat, treedef = jtu.tree_flatten_with_path(flax_params)

    def torch_name(path) -> str:
        keys = [str(getattr(k, "key", k)) for k in path]
        leaf = {"kernel": "weight", "embedding": "weight", "scale": "weight"}.get(keys[-1], keys[-1])
        return ".".join(keys[:-1] + [leaf])

    state = hf.state_dict()
    with torch.no_grad():
        for path, leaf in flat:
            name = torch_name(path)
            a = np.asarray(leaf)
            state[name].copy_(torch.from_numpy(a.T.copy() if path[-1].key == "kernel" else a))

    class Logits(nn.Module):
        def __init__(self):
            super().__init__()
            self.hf = hf

        def forward(self, x):  # noqa: D102
            logits = self.hf(input_ids=x, use_cache=False).logits
            return logits.reshape(-1, logits.shape[-1])

    def is_kfac(name: str) -> bool:
        return any(k in name for k in ("c_attn", "c_proj", "c_fc"))

    model = Logits()
    params = {n: p for n, p in model.named_parameters() if is_kfac(n)}
    tokens = np.random.default_rng(0).integers(0, 64, (2, 8))
    y = np.random.default_rng(1).integers(0, 64, (16,))
    kfac = KFACLinearOperator(model, CrossEntropyLoss("mean"), params,
                              [(torch.from_numpy(tokens), torch.from_numpy(y))],
                              fisher_type="type-2")

    kfac_flat = {jtu.keystr(p): l for p, l in flat if is_kfac(torch_name(p))}
    frozen_flat = {jtu.keystr(p): l for p, l in flat if not is_kfac(torch_name(p))}

    def raw_fn(frozen, kp, x):
        leaves = [kp[jtu.keystr(p)] if jtu.keystr(p) in kp else frozen[jtu.keystr(p)]
                  for p, _ in flat]
        out = flax_model(input_ids=x, params=jtu.tree_unflatten(treedef, leaves))
        return out.logits.reshape(-1, out.logits.shape[-1])

    jkfac = JKFAC(FrozenModelFn(raw_fn, frozen_flat), JCrossEntropyLoss("mean"), kfac_flat,
                  [(jnp.asarray(tokens), jnp.asarray(y))], fisher_type="type-2",
                  check_deterministic=False)
    names = {jtu.keystr(p): torch_name(p) for p, _ in flat}
    rng = np.random.default_rng(2)
    v_jax = {k: rng.standard_normal(np.shape(a)).astype(np.float32) for k, a in kfac_flat.items()}
    out_jax = jax_apply(jkfac, v_jax)
    return dict(model=model, flax=partial(flax_model, params=flax_params), tokens=tokens,
                kfac=kfac, jkfac=jkfac,
                names=names, v_jax=v_jax, out_jax=out_jax, params=params)


def _to_torch_layout(key: str, a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a.T if key.endswith("['kernel']") else a))


def test_hf_gpt2_conv1d_kfac_matches_flax(hf_gpt2):
    """The torch GPT-2's logits equal the Flax twin's; KFAC over its Conv1D
    weights has 8 groups (4 layers x (W, b)) of function-level ``addmm``
    uses on merged ``B * T`` rows, factors equal to the JAX operator's on
    the Flax kernels, the same matvec, and ``P (P^T v) = v``."""
    h = hf_gpt2
    with torch.no_grad():
        logits = h["model"](torch.from_numpy(h["tokens"]))
    jlogits = np.asarray(jax.jit(lambda t: h["flax"](input_ids=t).logits)(
        jnp.asarray(h["tokens"]))).reshape(16, -1)
    assert rel_fro(logits, jlogits) < HF_TOL
    kfac, jkfac, names = h["kfac"], h["jkfac"], h["names"]
    assert len(kfac.groups) == 8 == len(jkfac.groups)
    for u in (u for g in kfac.groups for u in g.uses):
        assert u.name.endswith(":addmm") and u.meta["merged_rows"] and u.meta["batch_major"]
    port = {g.key: gi for gi, g in enumerate(kfac.groups)}
    for jgi, g in enumerate(jkfac.groups):
        key = tuple(None if p is None else "hf." + names[p[0].key]
                    for p in (g.weight_path, g.bias_path))
        tgi = port[key]
        if jgi in jkfac._aaT:
            assert rel_fro(kfac._aaT[tgi], np.asarray(jkfac._aaT[jgi])) < HF_TOL, key
        assert rel_fro(kfac._ggT[tgi], np.asarray(jkfac._ggT[jgi])) < HF_TOL, key
    v = {"hf." + names[k]: _to_torch_layout(k, a) for k, a in h["v_jax"].items()}
    v = {k: v[k] for k in h["params"]}  # the operator's key order
    out = kfac @ v
    for k, a in h["out_jax"].items():
        assert rel_fro(out["hf." + names[k]], _to_torch_layout(k, a)) < HF_TOL, k
    back = kfac._from_canonical(kfac._to_canonical(v))
    assert all(torch.equal(back[k], v[k]) for k in v)
