"""curvlinops_tpu_torch: the PyTorch/CUDA port of ``curvlinops_tpu``.

The package mirrors ``curvlinops_tpu``'s module paths. It imports ``torch``
and never ``jax``; the JAX package stays the reference, and the port's
tests hold each module against its JAX counterpart on the CPU. The slices
ported so far run KFAC on ResNet-18/CIFAR-10 and on nanoGPT (GPT-2 small):
losses and loss-Hessian structure, the ResNet and GPT models, the operator
core (base, block-diagonal, eigh, Kronecker), and the KFAC collector,
factor computation, damped inverses and matvec. The TPU kernels on those
paths are hand-written CUDA kernels for Hopper: the conv input covariance
(``kfac/kernels.py``, ``kfac/csrc/``) and causal flash attention, forward
and backward (``models/flash_attention.py``, ``models/csrc/``).
"""

from curvlinops_tpu_torch.curvature.loss_hessian import FisherType, KFACType
from curvlinops_tpu_torch.kfac.operator import KFACLinearOperator
from curvlinops_tpu_torch.losses import BCEWithLogitsLoss, CrossEntropyLoss, MSELoss
from curvlinops_tpu_torch.models.gpt import GPTConfig, shakespeare_nanogpt
from curvlinops_tpu_torch.models.resnet import cifar10_resnet18
from curvlinops_tpu_torch.ops.base import (
    ChainLinearOperator,
    LinearOperator,
    PytreeLinearOperator,
    ScaledLinearOperator,
    SumLinearOperator,
)
from curvlinops_tpu_torch.ops.blockdiag import BlockDiagonalLinearOperator
from curvlinops_tpu_torch.ops.eigh import EighDecomposedLinearOperator
from curvlinops_tpu_torch.ops.kronecker import KroneckerProductLinearOperator

__all__ = [
    "FisherType",
    "KFACType",
    "KFACLinearOperator",
    "MSELoss",
    "CrossEntropyLoss",
    "BCEWithLogitsLoss",
    "LinearOperator",
    "PytreeLinearOperator",
    "SumLinearOperator",
    "ScaledLinearOperator",
    "ChainLinearOperator",
    "BlockDiagonalLinearOperator",
    "EighDecomposedLinearOperator",
    "KroneckerProductLinearOperator",
    "GPTConfig",
    "shakespeare_nanogpt",
    "cifar10_resnet18",
]
