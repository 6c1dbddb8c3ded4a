"""Model zoo: ResNet-18/50, the nanoGPT transformer, the ViT and the MNIST MLP."""

from curvlinops_tpu_torch.models.common import Problem, from_jax_params, to_jax_params
from curvlinops_tpu_torch.models.gpt import (
    GPT,
    TINY_GPT,
    GPTConfig,
    init_gpt,
    shakespeare_nanogpt,
    stack_gpt_blocks,
)
from curvlinops_tpu_torch.models.mlp import init_mlp, mlp_apply, mnist_mlp, tiny_mlp_problem
from curvlinops_tpu_torch.models.resnet import (
    ResNet,
    calibrate_bn,
    cifar10_resnet18,
    imagenet_resnet50,
    init_resnet,
    kfac_restricted,
    narrow_resnet,
    narrow_resnet_problem,
)
from curvlinops_tpu_torch.models.stack import StackedLinear, scan
from curvlinops_tpu_torch.models.vit import (
    TINY_VIT,
    ViT,
    ViTConfig,
    cifar10_vit,
    init_vit,
    stack_vit_blocks,
)

__all__ = [
    "GPT",
    "GPTConfig",
    "Problem",
    "ResNet",
    "StackedLinear",
    "TINY_GPT",
    "TINY_VIT",
    "ViT",
    "ViTConfig",
    "calibrate_bn",
    "cifar10_resnet18",
    "cifar10_vit",
    "from_jax_params",
    "imagenet_resnet50",
    "init_gpt",
    "init_mlp",
    "init_resnet",
    "init_vit",
    "kfac_restricted",
    "mlp_apply",
    "mnist_mlp",
    "narrow_resnet",
    "narrow_resnet_problem",
    "scan",
    "shakespeare_nanogpt",
    "stack_gpt_blocks",
    "stack_vit_blocks",
    "tiny_mlp_problem",
    "to_jax_params",
]
