"""Model zoo: ResNet-18/50 and the nanoGPT transformer (the KFAC main paths' models)."""

from curvlinops_tpu_torch.models.common import Problem, from_jax_params, to_jax_params
from curvlinops_tpu_torch.models.gpt import (
    GPT,
    TINY_GPT,
    GPTConfig,
    init_gpt,
    shakespeare_nanogpt,
)
from curvlinops_tpu_torch.models.resnet import (
    ResNet,
    calibrate_bn,
    cifar10_resnet18,
    imagenet_resnet50,
    init_resnet,
    kfac_restricted,
)

__all__ = [
    "GPT",
    "GPTConfig",
    "Problem",
    "ResNet",
    "TINY_GPT",
    "calibrate_bn",
    "cifar10_resnet18",
    "from_jax_params",
    "imagenet_resnet50",
    "init_gpt",
    "init_resnet",
    "kfac_restricted",
    "shakespeare_nanogpt",
    "to_jax_params",
]
