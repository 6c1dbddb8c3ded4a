"""Conv and multi-axis weight-sharing exactness of the port's KFAC, and bare
layers at the model's root.

The port's twins of ``tests/test_kfac_conv_exact.py``: for linear models (a
single conv, or a conv followed by average pooling) type-2 KFAC with EXPAND
or REDUCE equals the block-diagonal GGN exactly. The oracle is the port's
own dense GGN (held against JAX's in ``test_torch_curvature*.py``), in
float64 to 1e-10. The JAX oracles emit NHWC; MSE takes the last axis as the
feature axis in both packages, so the torch models emit channels-last too.
Besides the JAX test's 4x4 kernel with padding 2, ``"same"`` padding, stride
2 and 1x1 kernels are held for both approximations.

A bare ``nn.Linear`` and a bare ``nn.Conv2d`` with bias, each the whole
model, build KFAC (and the linear EKFAC; EKFAC takes 2d outputs only)
with their bias's owner the root module, and match the JAX package's bare
``{"W", "b"}`` layer under ``jax.enable_x64`` and the dense block-diagonal
GGN.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from curvlinops_tpu.kfac.ekfac import EKFACLinearOperator as JEKFAC
from curvlinops_tpu.kfac.operator import KFACLinearOperator as JKFAC
from curvlinops_tpu.losses import MSELoss as JMSELoss
from curvlinops_tpu_torch.kfac.ekfac import EKFACLinearOperator
from curvlinops_tpu_torch.kfac.operator import KFACLinearOperator
from curvlinops_tpu_torch.losses import MSELoss
from tests.test_torch_helpers import blockdiag_ggn, capped_torch_threads, rel_fro

_threads = capped_torch_threads()

RTOL = 1e-10  # float64: both sides are the same sums up to roundoff
JAX_RTOL = 1e-6  # JAX's KFAC under x64 agrees to 6e-8 / 3e-7 (linear KFAC / EKFAC)
GEOMETRIES = {
    "k4_pad2": dict(kernel_size=4, padding=2),  # tests/test_kfac_conv_exact.py's
    "same_k3": dict(kernel_size=3, padding="same"),
    "stride2_k3": dict(kernel_size=3, stride=2, padding=1),
    "k1": dict(kernel_size=1),
}


class ConvModel(nn.Module):
    """``[B, 3, 8, 8]`` through one conv to a channels-last ``[B, Ho, Wo, 2]``
    output, or (``pool``) its spatial mean ``[B, 2]``."""

    def __init__(self, geometry: str, bias: bool, pool: bool):
        super().__init__()
        self.conv = nn.Conv2d(3, 2, bias=bias, dtype=torch.float64, **GEOMETRIES[geometry])
        self.pool = pool

    def forward(self, x):  # noqa: D102
        z = self.conv(x)
        return z.mean(dim=(2, 3)) if self.pool else z.permute(0, 2, 3, 1)


def _conv_case(geometry: str, bias: bool, pool: bool, sizes, seed: int):
    rng = np.random.default_rng(seed)
    model = ConvModel(geometry, bias, pool)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.from_numpy(0.3 * rng.standard_normal(tuple(p.shape))))
    data = []
    for n in sizes:
        X = torch.from_numpy(rng.standard_normal((n, 3, 8, 8)))
        with torch.no_grad():
            out_shape = model(X).shape
        data.append((X, torch.from_numpy(rng.standard_normal(tuple(out_shape)))))
    return model, data


def _assert_exact(model, data, reduction, approx, separate=True, cls=KFACLinearOperator):
    params = dict(model.named_parameters())
    kw = {} if cls is EKFACLinearOperator else {"kfac_approx": approx}
    op = cls(model, MSELoss(reduction), params, data, fisher_type="type-2",
             separate_weight_and_bias=separate, check_deterministic=False, **kw)
    expected = blockdiag_ggn(model, MSELoss(reduction), params, data, op.groups)
    err = rel_fro(op.todense(), expected)
    assert err < RTOL, f"relative error {err}"
    return op


@pytest.mark.parametrize("separate", [True, False], ids=["separate", "joint"])
@pytest.mark.parametrize("bias", [True, False], ids=["bias", "no_bias"])
@pytest.mark.parametrize("reduction", ["mean", "sum"])
def test_conv_expand_exact(reduction, bias, separate):
    """One conv + MSE on its channels-last output: EXPAND is exact."""
    model, data = _conv_case("k4_pad2", bias, pool=False, sizes=[2, 7], seed=1)
    _assert_exact(model, data, reduction, "expand", separate)


@pytest.mark.parametrize("separate", [True, False], ids=["separate", "joint"])
@pytest.mark.parametrize("bias", [True, False], ids=["bias", "no_bias"])
@pytest.mark.parametrize("reduction", ["mean", "sum"])
def test_conv_reduce_exact(reduction, bias, separate):
    """Conv + global average pooling: REDUCE is exact."""
    model, data = _conv_case("k4_pad2", bias, pool=True, sizes=[1, 8], seed=2)
    _assert_exact(model, data, reduction, "reduce", separate)


@pytest.mark.parametrize("approx", ["expand", "reduce"])
@pytest.mark.parametrize("geometry", ["same_k3", "stride2_k3", "k1"])
def test_conv_geometries_exact(geometry, approx):
    """``"same"`` padding, stride 2 and a 1x1 kernel, with bias: EXPAND on
    the spatial output and REDUCE after pooling are exact."""
    pool = approx == "reduce"
    model, data = _conv_case(geometry, True, pool=pool, sizes=[2, 3], seed=3)
    _assert_exact(model, data, "mean", approx)


class TwoSharingDims(nn.Module):
    """Deep linear ``5 -> 4 -> 3`` over ``[B, 4, 8, 5]`` inputs."""

    def __init__(self):
        super().__init__()
        self.l0 = nn.Linear(5, 4, dtype=torch.float64)
        self.l1 = nn.Linear(4, 3, dtype=torch.float64)

    def forward(self, x):  # noqa: D102
        return self.l1(self.l0(x))


@pytest.mark.parametrize("reduction", ["mean", "sum"])
def test_two_sharing_dims_expand_exact(reduction):
    """Deep linear over two weight-sharing axes: EXPAND is exact."""
    rng = np.random.default_rng(4)
    model = TwoSharingDims()
    data = [
        (torch.from_numpy(rng.standard_normal((n, 4, 8, 5))),
         torch.from_numpy(rng.standard_normal((n, 4, 8, 3))))
        for n in (2, 7)
    ]
    _assert_exact(model, data, reduction, "expand")


# ---------------------------------------------------------------------- #
# bare layers at the model's root, against the JAX package's {"W", "b"}
# ---------------------------------------------------------------------- #
def _bare(layer: str):
    """A bare layer with bias in both packages from one seed: the torch
    module, the JAX ``(model_fn, params)``, and the data for each."""
    rng = np.random.default_rng(5)
    if layer == "linear":
        W, b = rng.standard_normal((4, 3)) / 2, 0.1 * rng.standard_normal(3)  # [in, out]
        X, y = rng.standard_normal((5, 4)), rng.standard_normal((5, 3))
        model = nn.Linear(4, 3, dtype=torch.float64)
        weight = W.T

        def model_fn(p, x):
            return x @ p["W"] + p["b"]

        data_t = [(torch.from_numpy(X), torch.from_numpy(y))]
    else:
        # one output channel: the root conv emits NCHW, and MSE takes the
        # last axis as the feature axis; with one channel each output entry
        # is its own row in both layouts, as in the JAX package's NHWC
        W, b = 0.3 * rng.standard_normal((3, 3, 3, 1)), 0.1 * rng.standard_normal(1)  # HWIO
        X, y = rng.standard_normal((3, 6, 6, 3)), rng.standard_normal((3, 6, 6, 1))  # NHWC
        model = nn.Conv2d(3, 1, 3, padding=1, dtype=torch.float64)
        weight = W.transpose(3, 2, 0, 1)

        def model_fn(p, x):
            z = jax.lax.conv_general_dilated(
                x, p["W"], (1, 1), [(1, 1), (1, 1)], dimension_numbers=("NHWC", "HWIO", "NHWC")
            )
            return z + p["b"]

        data_t = [(torch.from_numpy(X.transpose(0, 3, 1, 2)),
                   torch.from_numpy(y.transpose(0, 3, 1, 2)))]
    with torch.no_grad():
        model.weight.copy_(torch.from_numpy(weight))
        model.bias.copy_(torch.from_numpy(b))
    return model, data_t, model_fn, {"W": W, "b": b}, [(X, y)], weight.shape


@pytest.fixture(scope="module")
def bare_jax():
    """JAX's KFAC and EKFAC matvecs of each bare layer (float64), built once."""
    out = {}
    with jax.enable_x64(True):
        for layer in ("linear", "conv"):
            _, _, model_fn, params, data, _ = _bare(layer)
            rng = np.random.default_rng(6)
            v = {k: rng.standard_normal(np.shape(a)) for k, a in params.items()}
            for name, cls in (("kfac", JKFAC), ("ekfac", JEKFAC)):
                if (layer, name) == ("conv", "ekfac"):
                    continue  # EKFAC takes 2d model outputs only (test below)
                op = cls(model_fn, JMSELoss("sum"), jax.tree.map(jnp.asarray, params),
                         [tuple(map(jnp.asarray, d)) for d in data], fisher_type="type-2",
                         check_deterministic=False)
                out[layer, name] = (v, jax.tree.map(np.asarray, op @ v))
    return out


@pytest.mark.parametrize("cls", [KFACLinearOperator, EKFACLinearOperator], ids=["kfac", "ekfac"])
@pytest.mark.parametrize("layer", ["linear", "conv"])
def test_bare_layer_with_bias(bare_jax, layer, cls):
    """A root ``nn.Linear``/``nn.Conv2d`` with bias: its weight and bias form
    the groups (the bias's owner is the root module), KFAC and EKFAC equal
    the block-diagonal GGN and the JAX package's bare layer. EKFAC takes 2d
    model outputs only, so both packages refuse the bare conv's 4d output."""
    model, data, model_fn, params, jdata, w_shape = _bare(layer)
    if layer == "conv" and cls is EKFACLinearOperator:
        for build in (
            lambda: cls(model, MSELoss("sum"), dict(model.named_parameters()), data,
                        fisher_type="type-2"),
            lambda: JEKFAC(model_fn, JMSELoss("sum"), params, jdata, fisher_type="type-2"),
        ):
            with pytest.raises(ValueError, match="2d model output"):
                build()
        return
    op = _assert_exact(model, data, "sum", "expand", cls=cls)
    assert sorted(g.bias_path or g.weight_path for g in op.groups) == ["bias", "weight"]
    v_jax, out_jax = bare_jax[layer, "ekfac" if cls is EKFACLinearOperator else "kfac"]
    to_torch = (lambda W: W.T) if layer == "linear" else (lambda W: W.transpose(3, 2, 0, 1))
    v = {"weight": torch.from_numpy(np.ascontiguousarray(to_torch(v_jax["W"]))),
         "bias": torch.from_numpy(v_jax["b"])}
    out = op @ v
    assert tuple(out["weight"].shape) == tuple(w_shape)
    assert rel_fro(out["weight"], to_torch(out_jax["W"])) < JAX_RTOL
    assert rel_fro(out["bias"], out_jax["b"]) < JAX_RTOL
