"""ResNet-18 / ResNet-50 as ``nn.Module``s with eval-mode BatchNorm.

PyTorch counterpart of ``curvlinops_tpu/models/resnet.py``. Activations are
NCHW and kernels OIHW (PyTorch's layouts); parameter names follow the JAX
pytree paths (``layer2.block0.downsample.conv.weight`` for
``['layer2']['block0']['downsample']['conv']['W']``), and
:func:`from_jax_params` / :func:`to_jax_params` carry weights and
parameter-space vectors between the two packages (re-exported from
:mod:`~curvlinops_tpu_torch.models.common`).

The JAX model pads its convolutions ``"SAME"``, which is asymmetric for
stride 2: the 7x7/s2 stem pads ``(2, 3)`` on a 32x32 input and every 3x3/s2
conv ``(0, 1)``. PyTorch's symmetric ``padding=`` gives the same output size
from shifted windows, so :class:`SamePadConv2d` pads explicitly with
``F.pad`` and convolves with ``padding=0``; the KFAC collector reads its
``(lo, hi)`` pads from :meth:`SamePadConv2d.same_pads`.

BatchNorm is the eval-mode affine ``scale * x + bias`` (running statistics
folded in), like the reference's ``model.eval()``; :func:`calibrate_bn`
folds one batch's statistics into it.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from curvlinops_tpu_torch.losses import CrossEntropyLoss
from curvlinops_tpu_torch.models.common import (  # noqa: F401  (mapping re-exported)
    Problem,
    from_jax_params,
    he_normal,
    resolve_device,
    to_jax_params,
)

_BN_EPS = 1e-5


def same_pads(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """``(lo, hi)`` zero padding of JAX's ``"SAME"`` along one dimension."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class SamePadConv2d(nn.Conv2d):
    """Bias-free ``Conv2d`` with JAX ``"SAME"`` padding applied explicitly."""

    def __init__(self, c_in: int, c_out: int, kernel: int, stride: int = 1):
        super().__init__(c_in, c_out, kernel, stride=stride, padding=0, bias=False)

    def same_pads(self, h: int, w: int) -> tuple[tuple[int, int], tuple[int, int]]:
        """``((lo_h, hi_h), (lo_w, hi_w))`` for an ``h x w`` input."""
        (kh, kw), (sh, sw) = self.kernel_size, self.stride
        return same_pads(h, kh, sh), same_pads(w, kw, sw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # noqa: D102
        (lh, hh), (lw, hw) = self.same_pads(x.shape[-2], x.shape[-1])
        return super().forward(F.pad(x, (lw, hw, lh, hh)))


class BatchNormAffine(nn.Module):
    """Eval-mode BatchNorm: the per-channel affine ``scale * x + bias``."""

    def __init__(self, c: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # noqa: D102
        return self.scale[:, None, None] * x + self.bias[:, None, None]


class Downsample(nn.Module):
    """Projection shortcut: 1x1 conv and BatchNorm."""

    def __init__(self, c_in: int, c_out: int, stride: int):
        super().__init__()
        self.conv = SamePadConv2d(c_in, c_out, 1, stride)
        self.bn = BatchNormAffine(c_out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # noqa: D102
        return self.bn(self.conv(x))


class BasicBlock(nn.Module):
    """Two 3x3 convs with a residual connection (ResNet-18/34)."""

    def __init__(self, c_in: int, c_out: int, stride: int):
        super().__init__()
        self.conv1 = SamePadConv2d(c_in, c_out, 3, stride)
        self.bn1 = BatchNormAffine(c_out)
        self.conv2 = SamePadConv2d(c_out, c_out, 3, 1)
        self.bn2 = BatchNormAffine(c_out)
        self.downsample = (
            Downsample(c_in, c_out, stride) if stride != 1 or c_in != c_out else None
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # noqa: D102
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 -> 1x1 convs with a residual connection (ResNet-50)."""

    def __init__(self, c_in: int, width: int, stride: int):
        super().__init__()
        c_out = 4 * width
        self.conv1 = SamePadConv2d(c_in, width, 1, 1)
        self.bn1 = BatchNormAffine(width)
        self.conv2 = SamePadConv2d(width, width, 3, stride)
        self.bn2 = BatchNormAffine(width)
        self.conv3 = SamePadConv2d(width, c_out, 1, 1)
        self.bn3 = BatchNormAffine(c_out)
        self.downsample = (
            Downsample(c_in, c_out, stride) if stride != 1 or c_in != c_out else None
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # noqa: D102
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


_CONFIGS = {
    "resnet18": dict(block="basic", layers=(2, 2, 2, 2), widths=(64, 128, 256, 512)),
    "resnet50": dict(block="bottleneck", layers=(3, 4, 6, 3), widths=(64, 128, 256, 512)),
}


class ResNet(nn.Module):
    """ResNet forward pass ``[N, 3, H, W] -> [N, num_classes]``.

    Stages are ``layer1`` .. ``layer4``, each a ``ModuleDict`` of blocks
    ``block0``, ``block1``, ...; the first block of stages 2-4 has stride 2.
    """

    def __init__(
        self,
        block: str,
        layers: tuple,
        widths: tuple,
        num_classes: int,
        stem_width: int = 64,
    ):
        super().__init__()
        self.conv1 = SamePadConv2d(3, stem_width, 7, 2)
        self.bn1 = BatchNormAffine(stem_width)
        c_in = stem_width
        for si, (n_blocks, width) in enumerate(zip(layers, widths)):
            stage = nn.ModuleDict()
            for bi in range(n_blocks):
                stride = 2 if (si > 0 and bi == 0) else 1
                if block == "basic":
                    stage[f"block{bi}"] = BasicBlock(c_in, width, stride)
                    c_in = width
                else:
                    stage[f"block{bi}"] = Bottleneck(c_in, width, stride)
                    c_in = 4 * width
            setattr(self, f"layer{si + 1}", stage)
        self.num_stages = len(layers)
        self.fc = nn.Linear(c_in, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # noqa: D102
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.max_pool2d(out, 3, 2, padding=1)
        for si in range(self.num_stages):
            for blk in getattr(self, f"layer{si + 1}").values():
                out = blk(out)
        return self.fc(out.mean(dim=(2, 3)))


def init_resnet(
    arch: str,
    num_classes: int,
    generator: torch.Generator,
    dtype=torch.float32,
    device="cuda",
) -> ResNet:
    """Build a ResNet with He-normal conv/linear weights, zero biases and
    identity BatchNorm, drawn on the CPU from ``generator`` and moved to
    ``device`` (a CUDA device unless the caller asks for the CPU; raises
    without one, :func:`~curvlinops_tpu_torch.models.common.resolve_device`)."""
    device = resolve_device(device)
    cfg = _CONFIGS[arch]
    model = ResNet(cfg["block"], cfg["layers"], cfg["widths"], num_classes)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (nn.Conv2d, nn.Linear)):
                fan_in = math.prod(mod.weight.shape[1:])
                mod.weight.copy_(he_normal(tuple(mod.weight.shape), fan_in, generator))
                if mod.bias is not None:
                    mod.bias.zero_()
    return model.to(device=device, dtype=dtype)


@torch.no_grad()
def calibrate_bn(model: nn.Module, x: torch.Tensor) -> dict[str, torch.Tensor]:
    """Fold one batch's per-channel statistics into the eval-mode BN affines.

    One forward pass in which each BN site, in order, computes
    ``scale = 1/sqrt(var + eps)`` and ``bias = -mean * scale`` from its own
    input and normalizes with them, so downstream sites see normalized
    inputs (the sequential stand-in for real running statistics; without it,
    eval-mode activations of a randomly initialized ResNet explode and the
    softmax saturates).

    Returns:
        The folded affines ``{"<bn>.scale": ..., "<bn>.bias": ...}``; the
        model itself is left unchanged (apply them with
        ``model.load_state_dict(affines, strict=False)``).
    """
    affines: dict[str, torch.Tensor] = {}

    def make_hook(name):
        def hook(mod, inputs, output):
            xin = inputs[0]
            xf = xin.float()
            mean = xf.mean(dim=(0, 2, 3))
            var = xf.var(dim=(0, 2, 3), unbiased=False)
            scale = (1.0 / torch.sqrt(var + _BN_EPS)).to(xin.dtype)
            bias = (-mean).to(xin.dtype) * scale
            affines[f"{name}.scale"], affines[f"{name}.bias"] = scale, bias
            return scale[:, None, None] * xin + bias[:, None, None]

        return hook

    handles = [
        mod.register_forward_hook(make_hook(name))
        for name, mod in model.named_modules()
        if isinstance(mod, BatchNormAffine)
    ]
    try:
        model(x)
    finally:
        for h in handles:
            h.remove()
    return affines


def kfac_restricted(
    model: nn.Module, include_embeddings: bool = False
) -> tuple[nn.Module, dict[str, torch.Tensor]]:
    """Select the parameters KFAC covers.

    Returns:
        ``(model, kfac_params)``: parameters under ``conv*``/``fc``/``dense*``/
        ``attn*``/``mlp*`` names (not under ``bn*``/``ln*``) with all dims
        <= 50k, and with ``include_embeddings`` the embedding tables
        (``wte``/``wpe``/``emb*`` names, any vocabulary size: KFAC stores the
        input covariance of a lookup as a diagonal vector). The rest stay in
        the module, which the operators call with
        ``torch.func.functional_call``.
    """

    def is_kfac(name: str, p: torch.Tensor) -> bool:
        parts = name.split(".")
        if any(s.startswith(("wte", "wpe", "emb")) for s in parts):
            return include_embeddings
        supported = any(
            s.startswith(("conv", "fc", "dense", "attn", "mlp")) for s in parts
        ) and not any(s.startswith(("bn", "ln")) for s in parts)
        return supported and all(d <= 50_000 for d in p.shape)

    return model, {n: p for n, p in model.named_parameters() if is_kfac(n, p)}


def _problem(name, arch, num_classes, batch_size, hw, calib, seed, dtype, device):
    device = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    model = init_resnet(arch, num_classes, gen, dtype, device)
    X = torch.rand((batch_size, 3, hw, hw), generator=gen, dtype=dtype).to(device)
    y = torch.randint(0, num_classes, (batch_size,), generator=gen).to(device)
    # normalized activation scales, like real running statistics
    model.load_state_dict(calibrate_bn(model, X[:calib]), strict=False)
    _, kfac_params = kfac_restricted(model)
    return Problem(
        name, model, CrossEntropyLoss("mean"), dict(model.named_parameters()),
        [(X, y)], kfac_params,
    )


NARROW_WIDTHS = (16, 16, 32, 32)


def narrow_resnet() -> ResNet:
    """A ResNet for 10 classes with one basic block per stage, widths
    16/16/32/32 and a 16-channel stem: every stride-2 padding case of
    ResNet-18 at a test size. Its weights are as ``nn.Module`` draws them."""
    return ResNet("basic", (1, 1, 1, 1), NARROW_WIDTHS, 10, stem_width=NARROW_WIDTHS[0])


def narrow_resnet_problem(device="cuda") -> Problem:
    """:func:`narrow_resnet` in float64 on two 16x16 images from seed 0:
    every parameter drawn from ``N(0, 1 / fan_in)``, BatchNorm calibrated on
    8 images of which the first two are the data (on two images the deepest
    1x1 maps would leave near-zero variances)."""
    device = resolve_device(device)
    gen = torch.Generator().manual_seed(0)
    model = narrow_resnet().double()
    with torch.no_grad():
        for p in model.parameters():
            fan_in = max(1, p[0].numel())
            p.copy_(torch.randn(p.shape, generator=gen, dtype=p.dtype) / math.sqrt(fan_in))
    X = torch.rand((8, 3, 16, 16), generator=gen, dtype=torch.float64)
    model.load_state_dict(calibrate_bn(model, X), strict=False)
    y = torch.randint(0, 10, (2,), generator=gen)
    model = model.to(device)
    _, kfac_params = kfac_restricted(model)
    return Problem(
        "narrow_resnet", model, CrossEntropyLoss("mean"), dict(model.named_parameters()),
        [(X[:2].to(device), y.to(device))], kfac_params,
    )


def cifar10_resnet18(
    batch_size: int = 512, seed: int = 0, dtype=torch.float32, device="cuda"
) -> Problem:
    """ResNet-18 on synthetic CIFAR-10 (3x32x32, 10 classes)."""
    return _problem(
        "synthetic_cifar10_resnet18", "resnet18", 10, batch_size, 32,
        min(batch_size, 64), seed, dtype, device,
    )


def imagenet_resnet50(
    batch_size: int = 64, seed: int = 0, dtype=torch.float32, device="cuda"
) -> Problem:
    """ResNet-50 on synthetic ImageNet (3x224x224, 1000 classes)."""
    return _problem(
        "synthetic_imagenet_resnet50", "resnet50", 1000, batch_size, 224,
        min(batch_size, 32), seed, dtype, device,
    )
