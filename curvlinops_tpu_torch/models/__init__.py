"""Model zoo: ResNet-18/50 (the KFAC main path's models)."""

from curvlinops_tpu_torch.models.common import Problem
from curvlinops_tpu_torch.models.resnet import (
    ResNet,
    calibrate_bn,
    cifar10_resnet18,
    from_jax_params,
    imagenet_resnet50,
    init_resnet,
    kfac_restricted,
    to_jax_params,
)

__all__ = [
    "Problem",
    "ResNet",
    "calibrate_bn",
    "cifar10_resnet18",
    "from_jax_params",
    "imagenet_resnet50",
    "init_resnet",
    "kfac_restricted",
    "to_jax_params",
]
