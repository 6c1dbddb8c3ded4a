"""Vision Transformer (ViT) as an ``nn.Module``.

PyTorch counterpart of ``curvlinops_tpu/models/vit.py``: ViT-S/4 for 32x32
inputs by default (patch 4, 6 layers, 6 heads, 384 wide, 10 classes). The
model takes NCHW images, as the ResNet port does. The patch embedding is
one ``nn.Conv2d`` with kernel = stride = patch and no padding, whose output
patches are flattened row-major to ``[B, N, C]`` (the JAX package's NHWC
reshape); a CLS token (``cls [1, 1, C]``) is prepended, a position table
(``pos [1, N + 1, C]``) added, and the encoder blocks use the GPT's
:class:`~curvlinops_tpu_torch.models.gpt.Block` with bidirectional einsum
attention. The head ``fc`` reads the CLS position after ``ln_f``.

KFAC covers the patch conv, the four dense layers of every block and the
head (``kfac_restricted``); the CLS token, the position table and the norms
stay in the module. ``scan_blocks=True`` stacks the encoder blocks into one
scanned block, as in ``models/gpt.py``, and ``remat_blocks`` (the default,
as in ``vit_apply``) rematerialises each block of it (``models/stack.py``).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from curvlinops_tpu_torch.losses import CrossEntropyLoss
from curvlinops_tpu_torch.models.common import Problem, lecun_normal, resolve_device
from curvlinops_tpu_torch.models.gpt import Block, LayerNorm, stack_blocks
from curvlinops_tpu_torch.models.resnet import kfac_restricted
from curvlinops_tpu_torch.models.stack import scan


@dataclass(frozen=True)
class ViTConfig:
    """Model geometry (defaults = ViT-S/4 for CIFAR-scale 32x32 inputs)."""

    image_size: int = 32
    patch_size: int = 4
    in_channels: int = 3
    n_layer: int = 6
    n_head: int = 6
    n_embd: int = 384
    num_classes: int = 10

    @property
    def n_patches(self) -> int:
        """Patches per image."""
        side = self.image_size // self.patch_size
        return side * side


class ViT(nn.Module):
    """Forward pass ``[B, C_in, H, W]`` images -> ``[B, num_classes]`` logits."""

    def __init__(self, config: ViTConfig, scan_blocks: bool = False, remat_blocks: bool = True):
        super().__init__()
        self.config, self.scan_blocks, self.remat_blocks = config, scan_blocks, remat_blocks
        C, P = config.n_embd, config.patch_size
        self.conv_patch = nn.Conv2d(config.in_channels, C, P, stride=P, padding=0)
        self.cls = nn.Parameter(torch.zeros(1, 1, C))
        self.pos = nn.Parameter(torch.zeros(1, config.n_patches + 1, C))
        if scan_blocks:
            self.h = Block(C, config.n_head, "einsum", causal=False, stack=config.n_layer)
        else:
            for i in range(config.n_layer):
                setattr(self, f"h{i}", Block(C, config.n_head, "einsum", causal=False))
        self.ln_f = LayerNorm(C)
        self.fc = nn.Linear(C, config.num_classes)

    def forward(self, images: torch.Tensor) -> torch.Tensor:  # noqa: D102
        B = images.shape[0]
        x = self.conv_patch(images).flatten(2).transpose(1, 2)  # [B, N, C]
        x = torch.cat([self.cls.expand(B, -1, -1), x], dim=1) + self.pos
        if self.scan_blocks:
            x = scan(self.h, x, self.config.n_layer, remat=self.remat_blocks)
        else:
            for i in range(self.config.n_layer):
                x = getattr(self, f"h{i}")(x)
        return self.fc(self.ln_f(x)[:, 0])


def stack_vit_blocks(model: ViT) -> ViT:
    """The scan-stacked ViT with the weights of the unrolled ``model``."""
    return stack_blocks(model, ViT(model.config, scan_blocks=True))


def init_vit(
    config: ViTConfig,
    generator: torch.Generator,
    dtype=torch.float32,
    device="cuda",
    scan_blocks: bool = False,
) -> ViT:
    """Build a ViT with the JAX package's initialisation, drawn on the CPU
    from ``generator`` and moved to ``device`` (raises without a CUDA device
    unless the caller asks for the CPU): LeCun-normal conv and dense weights,
    zero biases, CLS token and position table N(0, 0.02^2), identity norms.
    ``scan_blocks`` stacks the drawn blocks (:func:`stack_vit_blocks`)."""
    device = resolve_device(device)
    model = ViT(config)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (nn.Conv2d, nn.Linear)):
                fan_in = mod.weight[0].numel()
                mod.weight.copy_(lecun_normal(tuple(mod.weight.shape), fan_in, generator))
                mod.bias.zero_()
        model.cls.copy_(0.02 * torch.randn(model.cls.shape, generator=generator))
        model.pos.copy_(0.02 * torch.randn(model.pos.shape, generator=generator))
    if scan_blocks:
        model = stack_vit_blocks(model)
    return model.to(device=device, dtype=dtype)


def cifar10_vit(
    batch_size: int = 512,
    config: ViTConfig | None = None,
    seed: int = 0,
    dtype=torch.float32,
    device="cuda",
    scan_blocks: bool = False,
    remat_blocks: bool = True,
) -> Problem:
    """ViT-S/4 on synthetic CIFAR-10 (3x32x32 uniform images, 10 classes).

    ``scan_blocks=True`` stacks the encoder blocks into one scanned block,
    which ``remat_blocks`` rematerialises block by block.
    """
    config = config or ViTConfig()
    device = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    model = init_vit(config, gen, dtype, device, scan_blocks)
    model.remat_blocks = remat_blocks
    hw = config.image_size
    X = torch.rand((batch_size, config.in_channels, hw, hw), generator=gen, dtype=dtype).to(device)
    y = torch.randint(0, config.num_classes, (batch_size,), generator=gen).to(device)
    _, kfac_params = kfac_restricted(model)
    return Problem(
        "synthetic_cifar10_vit", model, CrossEntropyLoss("mean"),
        dict(model.named_parameters()), [(X, y)], kfac_params,
    )


TINY_VIT = ViTConfig(image_size=8, patch_size=4, n_layer=2, n_head=2, n_embd=16, num_classes=5)
