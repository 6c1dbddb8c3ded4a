"""Model zoo: ResNet-18/50, the nanoGPT transformer and the MNIST MLP."""

from curvlinops_tpu_torch.models.common import Problem, from_jax_params, to_jax_params
from curvlinops_tpu_torch.models.gpt import (
    GPT,
    TINY_GPT,
    GPTConfig,
    init_gpt,
    shakespeare_nanogpt,
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
    "init_mlp",
    "init_resnet",
    "kfac_restricted",
    "mlp_apply",
    "mnist_mlp",
    "narrow_resnet",
    "narrow_resnet_problem",
    "shakespeare_nanogpt",
    "tiny_mlp_problem",
    "to_jax_params",
]
