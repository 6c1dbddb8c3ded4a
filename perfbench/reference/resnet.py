"""Plain PyTorch reference of the ResNet configurations (He et al.,
arXiv:1512.03385, Table 1, basic blocks), written from the paper and the
configuration file alone.

It is a function of a parameter dict, with the parameter names the
benchmark uses on both sides (``layer2.block0.downsample.conv.weight``,
``bn1.scale``), so the same weights load into the program's model and feed
this forward pass. Convolutions pad as JAX's ``"SAME"`` (asymmetric at
stride 2), BatchNorm is the eval-mode affine ``scale * x + bias`` whose
values :func:`calibrate` folds from one batch's statistics, the stem is a
``k x k`` stride-``s`` conv, then a 3x3 stride-2 max pool (padding 1), four
stages and global average pooling into a linear head.

Nothing here imports the program; only ``torch``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

BN_EPS = 1e-5


def same_pads(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """``(lo, hi)`` zero padding of ``"SAME"`` along one axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def blocks(cfg: dict) -> list[tuple[str, int, int, int]]:
    """``(prefix, c_in, c_out, stride)`` of every basic block, in order."""
    out, c_in = [], cfg["stem_width"]
    for si, (n, width) in enumerate(zip(cfg["layers"], cfg["widths"])):
        for bi in range(n):
            stride = 2 if si > 0 and bi == 0 else 1
            out.append((f"layer{si + 1}.block{bi}", c_in, width, stride))
            c_in = width
    return out


def convs(cfg: dict) -> list[dict]:
    """Every conv in forward order: name, channels, kernel, stride and the
    spatial size of its input."""
    out, hw = [], cfg["image_size"]
    k, s = cfg["stem_kernel"], cfg["stem_stride"]
    out.append(dict(name="conv1", c_in=cfg["channels"], c_out=cfg["stem_width"], k=k, s=s, hw=hw))
    hw = -(-hw // s)
    hw = (hw + 2 - 3) // 2 + 1  # max pool 3x3, stride 2, padding 1
    for prefix, c_in, c_out, stride in blocks(cfg):
        out.append(dict(name=f"{prefix}.conv1", c_in=c_in, c_out=c_out, k=3, s=stride, hw=hw))
        hw_out = -(-hw // stride)
        out.append(dict(name=f"{prefix}.conv2", c_in=c_out, c_out=c_out, k=3, s=1, hw=hw_out))
        if stride != 1 or c_in != c_out:
            out.append(dict(name=f"{prefix}.downsample.conv", c_in=c_in, c_out=c_out, k=1,
                            s=stride, hw=hw))
        hw = hw_out
    return out


def _bn_names(conv_name: str) -> str:
    """The BatchNorm that follows a conv."""
    if conv_name.endswith("downsample.conv"):
        return conv_name[: -len("conv")] + "bn"
    return conv_name[:-len("conv1")] + "bn" + conv_name[-1]


def param_shapes(cfg: dict) -> dict[str, tuple]:
    """Every parameter's name and shape."""
    shapes = {}
    for c in convs(cfg):
        shapes[f"{c['name']}.weight"] = (c["c_out"], c["c_in"], c["k"], c["k"])
        bn = _bn_names(c["name"])
        shapes[f"{bn}.scale"] = (c["c_out"],)
        shapes[f"{bn}.bias"] = (c["c_out"],)
    width = cfg["widths"][-1]
    shapes["fc.weight"] = (cfg["num_classes"], width)
    shapes["fc.bias"] = (cfg["num_classes"],)
    return shapes


def kfac_layers(cfg: dict) -> list[tuple[str, str | None]]:
    """``(weight, bias or None)`` of each layer KFAC covers: every conv and
    the head (BatchNorm is left out)."""
    return [(f"{c['name']}.weight", None) for c in convs(cfg)] + [("fc.weight", "fc.bias")]


def kfac_shapes(cfg: dict) -> list[dict]:
    """Each layer :func:`kfac_layers` names as ``perfbench/work.py`` counts
    it: its rows (a conv's patch rows), input width, output width and
    whether it has a bias."""
    B, out = cfg["batch_size"], []
    for c in convs(cfg):
        hw = -(-c["hw"] // c["s"])
        out.append(dict(rows=B * hw * hw, d_in=c["k"] * c["k"] * c["c_in"], d_out=c["c_out"],
                        bias=False))
    out.append(dict(rows=B, d_in=cfg["widths"][-1], d_out=cfg["num_classes"], bias=True))
    return out


def forward_flops(cfg: dict) -> float:
    """One forward pass of a batch: two operations a multiply-add of every
    conv and of the head."""
    return sum(2 * layer["rows"] * layer["d_in"] * layer["d_out"] for layer in kfac_shapes(cfg))


def covariance_kernel_convs(cfg: dict) -> list[dict]:
    """The convs whose input covariance the conv input-covariance kernel
    takes: every conv after the stem."""
    return convs(cfg)[1:]


def init_weights(cfg: dict, generator: torch.Generator, device) -> dict[str, torch.Tensor]:
    """He-normal conv and head weights drawn in one call on ``device``,
    zero head bias, BatchNorm left at the identity (see :func:`calibrate`)."""
    shapes = param_shapes(cfg)
    dtype = getattr(torch, cfg["dtype"])
    weight_names = [n for n in shapes if n.endswith(".weight")]
    flat = torch.randn(sum(math.prod(shapes[n]) for n in weight_names), generator=generator,
                       dtype=dtype, device=device)
    out, at = {}, 0
    for n in weight_names:
        size = math.prod(shapes[n])
        fan_in = math.prod(shapes[n][1:])
        out[n] = flat[at:at + size].view(shapes[n]).mul_(math.sqrt(2.0 / fan_in))
        at += size
    for n, shape in shapes.items():
        if n not in out:
            fill = 1.0 if n.endswith(".scale") else 0.0
            out[n] = torch.full(shape, fill, dtype=dtype, device=device)
    return out


def make_batches(cfg: dict, generator: torch.Generator, count: int, device) -> list[tuple]:
    """``count`` batches of uniform images in [0, 1) and uniform labels."""
    B, C, hw = cfg["batch_size"], cfg["channels"], cfg["image_size"]
    X = torch.rand((count, B, C, hw, hw), generator=generator, dtype=getattr(torch, cfg["dtype"]),
                   device=device)
    y = torch.randint(0, cfg["num_classes"], (count, B), generator=generator, device=device)
    return [(X[i], y[i]) for i in range(count)]


def conv2d(x: torch.Tensor, w: torch.Tensor, stride: int) -> torch.Tensor:
    """Bias-free conv with ``"SAME"`` padding."""
    k = w.shape[-1]
    (lh, hh), (lw, hw) = same_pads(x.shape[-2], k, stride), same_pads(x.shape[-1], k, stride)
    return F.conv2d(F.pad(x, (lw, hw, lh, hh)), w, stride=stride)


def forward(params: dict, x: torch.Tensor, cfg: dict, taps: dict | None = None,
            bn_hook=None) -> torch.Tensor:
    """Logits ``[N, classes]``. ``taps`` (if given) receives each KFAC
    layer's ``(input, output)`` under its weight's name; ``bn_hook(name,
    x)`` (if given) replaces each BatchNorm's output (calibration)."""

    def conv(name, x, stride):
        out = conv2d(x, params[f"{name}.weight"], stride)
        if taps is not None:
            taps[f"{name}.weight"] = (x, out)
        return out

    def bn(name, x):
        if bn_hook is not None:
            return bn_hook(name, x)
        return params[f"{name}.scale"][:, None, None] * x + params[f"{name}.bias"][:, None, None]

    out = F.relu(bn("bn1", conv("conv1", x, cfg["stem_stride"])))
    out = F.max_pool2d(out, 3, 2, padding=1)
    for prefix, c_in, c_out, stride in blocks(cfg):
        h = F.relu(bn(f"{prefix}.bn1", conv(f"{prefix}.conv1", out, stride)))
        h = bn(f"{prefix}.bn2", conv(f"{prefix}.conv2", h, 1))
        if stride != 1 or c_in != c_out:
            out = bn(f"{prefix}.downsample.bn", conv(f"{prefix}.downsample.conv", out, stride))
        out = F.relu(h + out)
    pooled = out.mean(dim=(2, 3))
    logits = pooled @ params["fc.weight"].T + params["fc.bias"]
    if taps is not None:
        taps["fc.weight"] = (pooled, logits)
    return logits


@torch.no_grad()
def calibrate(params: dict, x: torch.Tensor, cfg: dict) -> None:
    """Fold one batch's per-channel statistics into every BatchNorm, in
    place: each site in forward order takes ``scale = 1 / sqrt(var + eps)``
    and ``bias = -mean * scale`` from its own input and normalizes with
    them, as running statistics of a trained network would (without it a
    randomly drawn ResNet's eval-mode activations explode)."""

    def hook(name, h):
        mean = h.mean(dim=(0, 2, 3))
        var = h.var(dim=(0, 2, 3), unbiased=False)
        scale = 1.0 / torch.sqrt(var + BN_EPS)
        params[f"{name}.scale"].copy_(scale)
        params[f"{name}.bias"].copy_(-mean * scale)
        return scale[:, None, None] * h - (mean * scale)[:, None, None]

    forward(params, x, cfg, bn_hook=hook)


def patches(x: torch.Tensor, k: int, stride: int) -> torch.Tensor:
    """A conv input's ``"SAME"``-padded patches ``[N * positions, k*k*C]``,
    each patch in (row, column, channel) order."""
    (lh, hh), (lw, hw) = same_pads(x.shape[-2], k, stride), same_pads(x.shape[-1], k, stride)
    xp = F.pad(x, (lw, hw, lh, hh))
    p = xp.unfold(2, k, stride).unfold(3, k, stride)  # [N, C, Ho, Wo, k, k]
    p = p.permute(0, 2, 3, 4, 5, 1)  # [N, Ho, Wo, k, k, C]
    return p.reshape(-1, k * k * x.shape[1])


def layer_rows(name: str, x: torch.Tensor, out_grad: torch.Tensor, cfg: dict) -> tuple:
    """A KFAC layer's input rows ``a`` and output-gradient rows ``g`` (one
    row per datum and output position), and the positions per datum."""
    if name == "fc.weight":
        return x, out_grad, 1
    conv = next(c for c in convs(cfg) if f"{c['name']}.weight" == name)
    a = patches(x, conv["k"], conv["s"])
    g = out_grad.permute(0, 2, 3, 1).reshape(-1, out_grad.shape[1])
    return a, g, g.shape[0] // x.shape[0]


def canonical(name: str, w: torch.Tensor) -> torch.Tensor:
    """A weight (or its gradient) as the ``[out, in]`` matrix that acts on
    :func:`layer_rows`' input rows: a conv's ``[O, C, k, k]`` in (row,
    column, channel) order."""
    if w.ndim == 4:
        return w.permute(0, 2, 3, 1).reshape(w.shape[0], -1)
    return w


def from_canonical(name: str, m: torch.Tensor, shape: tuple) -> torch.Tensor:
    """Inverse of :func:`canonical`."""
    if len(shape) == 4:
        O, C, kh, kw = shape
        return m.reshape(O, kh, kw, C).permute(0, 3, 1, 2)
    return m
