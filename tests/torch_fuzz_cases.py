"""The collector fuzz twins: the generators of ``tests/test_collector_fuzz.py``
in torch, and the port's exact-or-refused oracle (no tests here).

Each generator makes the same ``random.Random`` draws in the same order as
its JAX counterpart, so seed ``s`` gives the same architecture in both
packages; a drawn weight key seeds numpy (``np.random.default_rng(key)``)
instead of ``jax.random``. Each JAX segment maps to its torch idiom:
``dense`` -> ``x @ W``, ``dense_T`` -> ``x @ W.T``, ``dense_flat`` -> a
reshape view, ``dense_slice`` -> a slice (refused, as in JAX), ``cond`` ->
``torch.cond``, the ``while_dense`` mutation ->
``torch._higher_order_ops.while_loop`` (refused), JAX's conv layouts ->
``permute``s around ``F.conv1d``/``F.conv2d`` (a crop is an ``F.pad`` with a
negative pad), an embedding lookup -> an ``nn.Embedding`` module. The
parameters keep the JAX leaves' names and layouts (``W``/``b`` become
``weight``/``bias``), so ``from_jax_params`` carries JAX's weights across.

The oracle is the port's own dense GGN (``torch.cond`` inlined by
``curvlinops_tpu_torch/utils/cond.py``) projected block-diagonally onto
``kfac.groups``. This module imports no JAX: ``tests/test_torch_cuda.py``
and ``chip_smoke.py`` run the twins on the card.
"""

from __future__ import annotations

import math
import random

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from curvlinops_tpu_torch import CrossEntropyLoss, KFACLinearOperator, MSELoss
from curvlinops_tpu_torch.curvature.ggn import GGNLinearOperator
from curvlinops_tpu_torch.models.stack import StackedLinear, scan


def assert_close(actual, expected, rtol: float, atol: float, name: str) -> None:
    """``allclose`` on numpy copies of tensors/arrays, with a diff report."""
    a = actual.detach().cpu().numpy() if isinstance(actual, torch.Tensor) else np.asarray(actual)
    b = expected.detach().cpu().numpy() if isinstance(expected, torch.Tensor) else np.asarray(expected)
    assert a.shape == b.shape, f"{name}: shape {a.shape} vs {b.shape}"
    if not np.allclose(a, b, rtol=rtol, atol=atol):
        err = np.abs(a - b).max()
        raise AssertionError(f"{name}: max abs diff {err} (rtol={rtol}, atol={atol})")


def dense_of(op) -> torch.Tensor:
    """``op @ I``: an operator's dense matrix on its flat parameter order."""
    return op @ torch.eye(op.shape[1], dtype=op.dtype, device=op.device)


def blockdiag_projection(dense: torch.Tensor, params: dict, groups) -> torch.Tensor:
    """``dense`` with every entry outside the KFAC block structure of
    ``groups`` zeroed (a joint group keeps its weight-bias cross block), on
    the flat order of ``params``: ``tests/test_kfac.py::blockdiag_projection``
    by parameter name."""
    offsets, start = {}, 0
    for name, p in params.items():
        offsets[name] = range(start, start + p.numel())
        start += p.numel()
    out = torch.zeros_like(dense)
    for group in groups:
        idx = list(offsets[group.weight_path]) if group.weight_path is not None else []
        if group.bias_path is not None and (group.joint or group.weight_path is None):
            idx += list(offsets[group.bias_path])
        idx = torch.tensor(idx, device=dense.device)
        out[idx[:, None], idx[None, :]] = dense[idx[:, None], idx[None, :]]
    return out


def blockdiag_ggn(model, loss_fn, params: dict, data, groups) -> torch.Tensor:
    """The port's dense GGN of ``model`` projected onto the KFAC blocks of
    ``groups``: the exactness oracle of linear models under MSE."""
    G = dense_of(GGNLinearOperator(model, loss_fn, params, data, check_deterministic=False))
    return blockdiag_projection(G, params, groups)


_LEAF_TO_TORCH = {"W": "weight", "b": "bias"}


# ---------------------------------------------------------------------------
# draws: the JAX generators' draws, with numpy weights
# ---------------------------------------------------------------------------


def _key(rng):
    return rng.randrange(2**31)


def _normal(rng, shape, scale=0.4):
    return (scale * np.random.default_rng(_key(rng)).standard_normal(shape)).astype(np.float32)


def _randint(rng, shape, high):
    return np.random.default_rng(_key(rng)).integers(0, high, shape)


class Twin(nn.Module):
    """Parameters named as the JAX leaves (``seg0.W`` -> ``seg0.weight``),
    registered in JAX's sorted leaf order; ``forward`` runs ``segments``,
    each ``(module, x) -> x``, reading the parameters at call time."""

    def __init__(self, params: dict, segments: list):
        super().__init__()
        for group in sorted(params):
            sub = nn.Module()
            for leaf in sorted(params[group]):
                arr = torch.from_numpy(np.asarray(params[group][leaf]))
                if group == "emb":  # a lookup table: an nn.Embedding module
                    sub.E = nn.Embedding(*arr.shape, _weight=arr.clone())
                else:
                    sub.register_parameter(_LEAF_TO_TORCH.get(leaf, leaf), nn.Parameter(arr))
            self.add_module(group, sub)
        self.segments = segments

    def forward(self, x):  # noqa: D102
        for seg in self.segments:
            x = seg(self, x)
        return x


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a))


def _conv_input(x: torch.Tensor, perm: tuple) -> torch.Tensor:
    """``x.permute(perm)`` in the standard memory format. torch's CPU conv
    misreads an input that is both contiguous and channels-last, as a
    permuted size-1 channel axis leaves it: it returned wrong values, some
    of them uninitialised memory (torch 2.13, CPU)."""
    return x.permute(*perm).clone(memory_format=torch.contiguous_format)


# ---------------------------------------------------------------------------
# family 1: one-datum TYPE2, exact or refused
# ---------------------------------------------------------------------------


def _gen_first_segment(rng, params):
    kind = rng.choice(["features", "features", "conv_full", "embedding"])
    if kind == "features":
        d = rng.choice([2, 3, 4])
        return (lambda m, x: x), d, (lambda rng: _normal(rng, (1, d), 1.0))
    if kind == "conv_full":
        k, c, o = rng.choice([2, 3]), rng.choice([1, 2]), rng.choice([2, 3])
        params["conv"] = {"W": _normal(rng, (k, k, c, o))}

        def apply(m, x):  # NHWC input, HWIO kernel: one output location
            z = F.conv2d(_conv_input(x, (0, 3, 1, 2)), m.conv.weight.permute(3, 2, 0, 1))
            return z.reshape(z.shape[0], -1)

        return apply, o, (lambda rng: _normal(rng, (1, k, k, c), 1.0))
    v, d = rng.choice([5, 8]), rng.choice([2, 3])
    params["emb"] = {"E": _normal(rng, (v, d))}
    return (
        (lambda m, tok: m.emb.E(tok).reshape(tok.shape[0], -1)),
        d,
        (lambda rng: _randint(rng, (1, 1), v)),
    )


def _gen_segment(rng, idx, d_in, params):
    kind = rng.choice(
        ["dense", "dense", "dense_T", "dense_flat", "dense_slice", "bias_only", "cond"]
    )
    name = f"seg{idx}"
    if kind == "bias_only":
        params[name] = {"b": _normal(rng, (d_in,))}
        return (lambda m, x, n=name: x + getattr(m, n).bias), d_in

    d_out = rng.choice([2, 3, 4])
    bias = rng.random() < 0.6
    if kind == "dense":
        params[name] = {"W": _normal(rng, (d_in, d_out))}
        if bias:
            params[name]["b"] = _normal(rng, (d_out,), 0.1)

        def apply(m, x, n=name, bias=bias):
            h = x @ getattr(m, n).weight
            return h + getattr(m, n).bias if bias else h

        return apply, d_out
    if kind == "dense_T":
        params[name] = {"W": _normal(rng, (d_out, d_in))}
        return (lambda m, x, n=name: x @ getattr(m, n).weight.T), d_out
    if kind == "dense_flat":
        params[name] = {"w": _normal(rng, (d_in * d_out,))}
        return (lambda m, x, n=name, s=(d_in, d_out): x @ getattr(m, n).w.reshape(s)), d_out
    if kind == "dense_slice":
        params[name] = {"W": _normal(rng, (d_in + 2, d_out))}
        return (lambda m, x, n=name, d=d_in: x @ getattr(m, n).weight[1 : 1 + d]), d_out
    params[name] = {"Wa": _normal(rng, (d_in, d_out)), "Wb": _normal(rng, (d_in, d_out))}

    def apply(m, x, n=name):
        p = getattr(m, n)
        return torch.cond(x.sum() > 0.0, lambda x: x @ p.Wa, lambda x: x @ p.Wb, (x,))

    return apply, d_out


_ACTS = [torch.tanh, torch.relu, torch.sigmoid, None]


def _gen_mutation(rng, d_out, params, first_bias_name):
    kind = rng.choice(["reversed_bias", "elementwise", "tied_bias", "while_dense"])
    if kind == "reversed_bias":
        params["mut"] = {"b": _normal(rng, (d_out,), 0.1)}
        return lambda m, x: x + m.mut.bias.flip(0)
    if kind == "elementwise":
        params["mut"] = {"g": 1.0 + _normal(rng, (d_out,), 0.1)}
        return lambda m, x: x * m.mut.g
    if kind == "tied_bias" and first_bias_name is not None:
        n = first_bias_name

        def apply(m, x):
            b = getattr(m, n).bias
            return x + b if b.shape[0] == x.shape[-1] else x + b.sum()

        return apply
    if kind == "while_dense":
        params["mut"] = {"W": _normal(rng, (d_out, d_out))}

        def apply(m, x):
            out, _ = torch._higher_order_ops.while_loop(
                lambda c, i: i < 1, lambda c, i: (c @ m.mut.weight, i + 1),
                (x, torch.tensor(0)),
            )
            return out

        return apply
    return None


def build_case(seed):
    """``tests/test_collector_fuzz.py::build_case`` in torch."""
    rng = random.Random(seed)
    params = {}
    first, d, make_input = _gen_first_segment(rng, params)
    segments = [first]
    first_bias_name = None
    for idx in range(rng.choice([1, 2, 3])):
        act = rng.choice(_ACTS)
        if act is not None:
            segments.append(lambda m, x, a=act: a(x))
        seg, d = _gen_segment(rng, idx, d, params)
        segments.append(seg)
        name = f"seg{idx}"
        if first_bias_name is None and "b" in params.get(name, {}):
            first_bias_name = name
    if rng.random() < 0.3:
        mut = _gen_mutation(rng, d, params, first_bias_name)
        if mut is not None:
            segments.append(mut)

    X = _t(make_input(rng))
    if rng.random() < 0.5 and d >= 2:
        loss = CrossEntropyLoss(rng.choice(["mean", "sum"]))
        y = _t(_randint(rng, (1,), d))
    else:
        loss = MSELoss(rng.choice(["mean", "sum"]))
        y = _t(_normal(rng, (1, d), 1.0))
    return dict(
        model=Twin(params, segments), loss_fn=loss, data=[(X, y)],
        separate=rng.random() < 0.7, kfac_approx="expand", setting="",
    )


# ---------------------------------------------------------------------------
# family 2: a scanned stack equals its unrolled twin
# ---------------------------------------------------------------------------


def build_scan_pair(seed):
    """``tests/test_collector_fuzz.py::build_scan_pair`` in torch: the stack
    is a ``StackedLinear`` (``weight [L, out, in]``) applied by
    ``models/stack.py::scan``, the unrolled twin ``x @ W_l`` per layer."""
    rng = random.Random(seed)
    L = rng.choice([2, 3])
    d = rng.choice([2, 3])
    N = rng.choice([2, 4])
    act = rng.choice([torch.tanh, torch.relu, None])
    bias = rng.random() < 0.6
    head = rng.random() < 0.5

    Ws = _normal(rng, (L, d, d))
    bs = _normal(rng, (L, d), 0.1) if bias else None
    Wh = _normal(rng, (d, d)) if head else None

    def post(m, h):
        return h @ m.head.weight if head else h

    class Scanned(nn.Module):
        def __init__(self):
            super().__init__()
            self.stack = StackedLinear(L, d, d, bias=bias)
            with torch.no_grad():
                self.stack.weight.copy_(_t(Ws).transpose(1, 2))
                if bias:
                    self.stack.bias.copy_(_t(bs))
            if head:
                self.head = nn.Module()
                self.head.weight = nn.Parameter(_t(Wh))

        def forward(self, x):  # noqa: D102
            def body(h, layer):
                h = self.stack(h, layer)
                return act(h) if act is not None else h

            return post(self, scan(body, x, L))

    def unrolled_layer(m, h, l):
        layer = getattr(m, f"layer{l}")
        h = h @ layer.weight
        if bias:
            h = h + layer.bias
        return act(h) if act is not None else h

    unrolled_params = {
        f"layer{l}": {"W": Ws[l]} | ({"b": bs[l]} if bias else {}) for l in range(L)
    }
    if head:
        unrolled_params["head"] = {"W": Wh}
    segments = [lambda m, h, l=l: unrolled_layer(m, h, l) for l in range(L)]
    unrolled = Twin(unrolled_params, segments + [post])

    X = _t(_normal(rng, (N, d), 1.0))
    y = _t(_normal(rng, (N, d), 1.0))
    loss = MSELoss(rng.choice(["mean", "sum"]))
    sep = rng.random() < 0.7

    def to_unrolled(v: dict) -> dict:
        out = {}
        for l in range(L):
            out[f"layer{l}.weight"] = v["stack.weight"][l].T
            if bias:
                out[f"layer{l}.bias"] = v["stack.bias"][l]
        if head:
            out["head.weight"] = v["head.weight"]
        return out

    return dict(scanned=Scanned(), unrolled=unrolled, data=[(X, y)], loss=loss,
                separate=sep, to_unrolled=to_unrolled, L=L)


# ---------------------------------------------------------------------------
# family 3: deep-linear + MSE sharing and scaling (S > 1, several batches)
# ---------------------------------------------------------------------------


def _gen_linear_segment(rng, idx, d_in, params, prev_biased=False):
    kinds = ["dense", "dense", "dense_T", "dense_flat", "dense_slice"]
    if not prev_biased:
        kinds.append("bias_only")
    kind = rng.choice(kinds)
    name = f"seg{idx}"
    if kind == "bias_only":
        params[name] = {"b": _normal(rng, (d_in,))}
        return (lambda m, x, n=name: x + getattr(m, n).bias), d_in, True
    d_out = rng.choice([2, 3, 4])
    bias = rng.random() < 0.6
    if kind == "dense":
        params[name] = {"W": _normal(rng, (d_in, d_out))}
    elif kind == "dense_T":
        params[name] = {"W": _normal(rng, (d_out, d_in))}
    elif kind == "dense_flat":
        params[name] = {"w": _normal(rng, (d_in * d_out,))}
    else:  # dense_slice
        params[name] = {"W": _normal(rng, (d_in + 2, d_out))}
    if bias:
        params[name]["b"] = _normal(rng, (d_out,), 0.1)

    def apply(m, x, n=name, k=kind, d=d_in, o=d_out, bias=bias):
        p = getattr(m, n)
        if k == "dense":
            h = x @ p.weight
        elif k == "dense_T":
            h = x @ p.weight.T
        elif k == "dense_flat":
            h = x @ p.w.reshape(d, o)
        else:
            h = x @ p.weight[1 : 1 + d]
        return h + p.bias if bias else h

    return apply, d_out, bias


def build_linear_sharing_case(seed):
    """``tests/test_collector_fuzz.py::build_linear_sharing_case`` in torch."""
    rng = random.Random(seed)
    params = {}
    first_d = d = rng.choice([2, 3, 4])
    segments = []
    biased = False
    for idx in range(rng.choice([1, 2, 3])):
        seg, d, biased = _gen_linear_segment(rng, idx, d, params, biased)
        segments.append(seg)

    setting = rng.choice(["none", "expand", "expand", "reduce", "reduce"])
    share_dims = (
        ()
        if setting == "none"
        else tuple(rng.choice([2, 3, 5]) for _ in range(rng.choice([1, 1, 1, 2])))
    )
    head = setting == "reduce" and rng.random() < 0.5
    if head:
        params["head"] = {"W": _normal(rng, (d, rng.choice([2, 3])))}

    def tail(m, x):
        if setting == "reduce":
            x = x.mean(dim=tuple(range(1, 1 + len(share_dims))))
            if head:
                x = x @ m.head.weight
        return x

    d_out = d if not head else params["head"]["W"].shape[1]
    batches = rng.choice([1, 2, 3])
    sizes = [rng.choice([1, 2, 4]) for _ in range(batches)]
    data = []
    for B in sizes:
        X = _normal(rng, (B, *share_dims, first_d), 1.0)
        y_shape = (B, *share_dims, d_out) if setting == "expand" else (B, d_out)
        y = _normal(rng, y_shape, 1.0)
        data.append((_t(X), _t(y)))
    return dict(
        model=Twin(params, segments + [tail]),
        loss_fn=MSELoss(rng.choice(["mean", "sum"])),
        data=data,
        separate=rng.random() < 0.7,
        kfac_approx="reduce" if setting == "reduce" else "expand",
        setting=setting,
    )


# ---------------------------------------------------------------------------
# family 4: conv weight sharing (layouts x groups x strides x dilation)
# ---------------------------------------------------------------------------

_RHS_2D = ["HWIO", "OIHW"]
_LHS_2D = ["NHWC", "NCHW"]
_RHS_1D = ["WIO", "OIW"]
_LHS_1D = ["NWC", "NCW"]


def _weight_shape(rhs_spec, c_in_pg, c_out, ksizes):
    spatial = iter(ksizes)
    return tuple(
        c_out if ch == "O" else c_in_pg if ch == "I" else next(spatial) for ch in rhs_spec
    )


def _channel_axis(layout):
    return layout.index("C")


def _spatial_axes(layout):
    return tuple(i for i, ch in enumerate(layout) if ch not in "NC")


def _to(layout: str, target: str) -> tuple:
    """The permutation taking an array in ``layout`` to ``target``."""
    return tuple(layout.index(ch) for ch in target)


def _same_pads(n, k, s, d):
    """XLA's ``SAME`` padding of one spatial axis (the odd pixel at the end)."""
    total = max((math.ceil(n / s) - 1) * s + d * (k - 1) + 1 - n, 0)
    return total // 2, total - total // 2


def _gen_conv_layer(rng, idx, layout, c_in, spatial, params, *, first, groups=1):
    """One conv segment: ``(apply, out_layout, c_out, out_spatial, groups)``;
    the input is permuted to ``[N, C, *spatial]``, the kernel to
    ``[O, I, *K]``, a crop is an ``F.pad`` with a negative pad."""
    nd = len(spatial)
    rhs = rng.choice(_RHS_2D if nd == 2 else _RHS_1D)
    out_layout = rng.choice(_LHS_2D if nd == 2 else _LHS_1D)
    name = f"conv{idx}"
    if first:
        ksizes = tuple(rng.randint(1, min(3, s)) for s in spatial)
        strides = tuple(rng.choice([1, 1, 2]) for _ in spatial)
        pad_kind = rng.choice(["VALID", "VALID", "SAME", "negative"])
        if pad_kind == "negative" and all(s - k >= 1 for s, k in zip(spatial, ksizes)):
            padding = [(-1, 0)] + [(0, 0)] * (nd - 1)
        elif pad_kind == "SAME":
            padding = "SAME"
        else:
            padding = "VALID"
        rhs_dilation = tuple(
            rng.choice([1, 1, 1, 2]) if (k - 1) * 2 + 1 <= s else 1
            for k, s in zip(ksizes, spatial)
        )
    else:
        ksizes = (1,) * nd
        strides = (1,) * nd
        padding = "VALID"
        rhs_dilation = (1,) * nd
    c_out = rng.choice([2, 3]) if groups == 1 else rng.choice([2, 4])
    c_in_pg = c_in // groups
    params[name] = {"W": _normal(rng, _weight_shape(rhs, c_in_pg, c_out, ksizes))}
    bias = rng.random() < 0.5
    if bias:
        params[name]["b"] = _normal(rng, (c_out,), 0.1)

    canon = "NCHW" if nd == 2 else "NCW"
    kernel_canon = "OIHW" if nd == 2 else "OIW"
    if padding == "SAME":
        pads = [_same_pads(*a) for a in zip(spatial, ksizes, strides, rhs_dilation)]
    elif padding == "VALID":
        pads = [(0, 0)] * nd
    else:
        pads = padding
    # F.pad takes the last axis first; ``"same"`` where torch accepts it
    torch_pad = [p for lo_hi in reversed(pads) for p in lo_hi]
    use_same = padding == "SAME" and all(s == 1 for s in strides)
    conv = F.conv2d if nd == 2 else F.conv1d

    def apply(m, x, n=name):
        p = getattr(m, n)
        x = _conv_input(x, _to(layout, canon))
        if not use_same and any(torch_pad):
            x = F.pad(x, torch_pad)
        z = conv(x, p.weight.permute(*_to(rhs, kernel_canon)), None, strides,
                 "same" if use_same else 0, rhs_dilation, groups)
        if bias:
            z = z + p.bias.reshape(1, -1, *(1,) * nd)
        return z.permute(*_to(canon, out_layout))

    out_spatial = tuple(
        (n + lo + hi - d * (k - 1) - 1) // s + 1
        for n, (lo, hi), k, s, d in zip(spatial, pads, ksizes, strides, rhs_dilation)
    )
    return apply, out_layout, c_out, out_spatial, groups


def build_conv_sharing_case(seed):
    """``tests/test_collector_fuzz.py::build_conv_sharing_case`` in torch."""
    rng = random.Random(seed)
    params = {}
    nd = rng.choice([1, 2])
    spatial = (
        tuple(rng.choice([3, 4, 5]) for _ in range(2)) if nd == 2 else (rng.choice([4, 6, 8]),)
    )
    layout = rng.choice(_LHS_2D if nd == 2 else _LHS_1D)
    in_layout = layout
    c_in = rng.choice([1, 2, 3])

    segments = []
    cur_spatial = spatial
    first_groups = 2 if rng.random() < 0.3 else 1
    if first_groups > 1:
        c_in = rng.choice([2, 4])
    c = c_in
    n_layers = rng.choice([1, 1, 2, 3])
    for idx in range(n_layers):
        seg, layout, c, cur_spatial, g = _gen_conv_layer(
            rng, idx, layout, c, cur_spatial, params, first=(idx == 0),
            groups=first_groups if idx == 0 else 1,
        )
        segments.append(seg)
        if any(s < 1 for s in cur_spatial):  # over-cropped draw
            return None

    setting = rng.choice(["expand", "expand", "reduce", "reduce"])
    flatten = setting == "expand" and rng.random() < 0.3
    head = setting == "reduce" and rng.random() < 0.5
    if head:
        params["head"] = {"W": _normal(rng, (c, rng.choice([2, 3])))}

    final_layout = layout
    sp_axes = _spatial_axes(final_layout)
    c_ax = _channel_axis(final_layout)
    to_channels_last = (0, *sp_axes, c_ax)

    def tail(m, x):
        if setting == "reduce":
            x = x.mean(dim=sp_axes)
            return x @ m.head.weight if head else x
        x = x.permute(*to_channels_last)
        return x.reshape(x.shape[0], -1) if flatten else x

    d_out = c if not head else params["head"]["W"].shape[1]
    in_sp_axes = _spatial_axes(in_layout)
    in_c_ax = _channel_axis(in_layout)

    def make_X(rng, B):
        shape = [B] * len(in_layout)
        for a, s in zip(in_sp_axes, spatial):
            shape[a] = s
        if first_groups > 1:  # group-replicated input channels
            shape[in_c_ax] = c_in // first_groups
            base = _normal(rng, tuple(shape), 1.0)
            return np.concatenate([base] * first_groups, axis=in_c_ax)
        shape[in_c_ax] = c_in
        return _normal(rng, tuple(shape), 1.0)

    out_spatial = cur_spatial
    batches = rng.choice([1, 2])
    data = []
    for _ in range(batches):
        B = rng.choice([1, 2, 4])
        X = make_X(rng, B)
        if setting == "reduce":
            y = _normal(rng, (B, d_out), 1.0)
        elif flatten:
            y = _normal(rng, (B, int(np.prod(out_spatial)) * c), 1.0)
        else:
            y = _normal(rng, (B, *out_spatial, c), 1.0)
        data.append((_t(X), _t(y)))

    return dict(
        model=Twin(params, segments + [tail]),
        loss_fn=MSELoss(rng.choice(["mean", "sum"])),
        data=data,
        separate=rng.random() < 0.7,
        kfac_approx=setting,
        setting=f"{setting} nd={nd} groups={first_groups}",
    )


# ---------------------------------------------------------------------------
# the oracle
# ---------------------------------------------------------------------------


def _moved(X: torch.Tensor, device, dtype) -> torch.Tensor:
    X = X.to(device)
    return X.to(dtype) if dtype is not None and X.is_floating_point() else X


def kfac_of(case, device="cpu", dtype=None):
    """The case's TYPE2 KFAC, its parameters and data on ``device`` (in
    ``dtype``, if given); ``ValueError``/``NotImplementedError`` is a refusal."""
    model = case["model"].to(device=device, dtype=dtype)
    params = dict(model.named_parameters())
    data = [(_moved(X, device, dtype), _moved(y, device, dtype)) for X, y in case["data"]]
    return KFACLinearOperator(
        model, case["loss_fn"], params, data, fisher_type="type-2",
        kfac_approx=case["kfac_approx"], separate_weight_and_bias=case["separate"],
        check_deterministic=False,
    ), params, data


def exact_or_refused(case, seed, atol, device="cpu", dtype=None) -> bool:
    """Whether the case built; if it did, its KFAC equals the block-diagonal
    dense GGN (``rtol=5e-3``, JAX's ``atol``)."""
    try:
        kfac, params, data = kfac_of(case, device, dtype)
        dense_kfac = dense_of(kfac)
    except (ValueError, NotImplementedError):
        return False
    expected = blockdiag_ggn(case["model"], case["loss_fn"], params, data, kfac.groups)
    assert_close(dense_kfac, expected, rtol=5e-3, atol=atol,
                 name=f"seed {seed} ({case['setting']})")
    return True


def run_chunk(build, seeds, atol, device="cpu", dtype=None) -> tuple[int, int]:
    """``(built, refused)`` over ``seeds`` (a degenerate draw counts neither)."""
    built, refused = 0, 0
    for seed in seeds:
        case = build(seed)
        if case is None:
            continue
        if exact_or_refused(case, seed, atol, device, dtype):
            built += 1
        else:
            refused += 1
    return built, refused


def scan_equals_unrolled(seed, device="cpu", dtype=None) -> None:
    """A scanned stack's KFAC matvec equals its unrolled twin's, slice by
    slice (``rtol=5e-4, atol=5e-5``)."""
    c = build_scan_pair(seed)
    kw = dict(fisher_type="type-2", separate_weight_and_bias=c["separate"],
              check_deterministic=False)
    data = [(_moved(X, device, dtype), _moved(y, device, dtype)) for X, y in c["data"]]
    scanned = c["scanned"].to(device=device, dtype=dtype)
    unrolled = c["unrolled"].to(device=device, dtype=dtype)
    p_s, p_u = dict(scanned.named_parameters()), dict(unrolled.named_parameters())
    k_s = KFACLinearOperator(scanned, c["loss"], p_s, data, **kw)
    k_u = KFACLinearOperator(unrolled, c["loss"], p_u, data, **kw)
    gen = torch.Generator().manual_seed(seed)
    v_s = {n: torch.randn(p.shape, generator=gen).to(p) for n, p in p_s.items()}
    r_s = c["to_unrolled"](k_s @ v_s)
    r_u = k_u @ {n: c["to_unrolled"](v_s)[n] for n in p_u}
    for name, r in r_u.items():
        assert_close(r_s[name], r, rtol=5e-4, atol=5e-5, name=f"seed {seed} {name}")
