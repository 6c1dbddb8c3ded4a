"""curvlinops_tpu_torch: the PyTorch/CUDA port of ``curvlinops_tpu``.

The package mirrors ``curvlinops_tpu``'s module paths. It imports ``torch``
and never ``jax``; the JAX package stays the reference, and the port's
tests hold each module against its JAX counterpart on the CPU. The slices
ported so far run the KFAC family (KFAC with EXPAND and REDUCE, its exact,
heuristic and randomized rank-``r`` damped inverses, EKFAC and KFOC) on
ResNet-18/CIFAR-10, on nanoGPT (GPT-2 small; unrolled or scan-stacked
blocks, einsum, flash or fused attention, embedding KFAC) and on the ViT,
the empirical-risk curvature operators, and the structured operators and
the on-device solvers: losses and loss-Hessian structure, the ResNet, GPT,
ViT and MLP models, the operator core (base with ``to_scipy``, dense, diagonal,
block-diagonal, eigh, Kronecker and embedding blocks, stacked, submatrix),
the solvers (CG, MINRES, LSMR, Lanczos, LOBPCG) and the inverse operators
built on them (CG, MINRES, LSMR, Neumann), the KFAC collector, factor computation,
damped inverses (``kfac/randomized.py`` for ``rank=``) and matvec, EKFAC
(``kfac/ekfac.py``) and KFOC (``kfac/kfoc.py``), ``risk.py``'s ``EmpiricalRiskOperator`` and
the GGN/MC-Fisher, Hessian, empirical-Fisher and (transposed) Jacobian
operators built on it, their held linearizations (``op.linearized()``,
:mod:`curvature.held`), the exact and Monte-Carlo GGN diagonal
(:mod:`curvature.ggn_diagonal`), the stochastic estimators (Hutchinson,
Hutch++ and XTrace traces, Hutchinson and XDiag diagonals, the squared
Frobenius norm, stochastic Lanczos quadrature for ``tr(f(A))`` and the
log-determinant; :mod:`estimators`), data parallelism over
``torch.distributed`` meshes (``mesh=`` on every operator, :mod:`parallel`),
the device-prefetching data pipeline (:mod:`utils.prefetch`), and the dense
oracles of :mod:`examples`. The TPU
kernels on those paths are hand-written CUDA kernels for Hopper: the conv
input covariance (``kfac/kernels.py``, ``kfac/csrc/``) and causal flash
attention, forward and backward (``models/flash_attention.py``,
``models/csrc/``).
"""

from curvlinops_tpu_torch import examples
from curvlinops_tpu_torch.curvature.ef import EFLinearOperator
from curvlinops_tpu_torch.curvature.ggn import GGNLinearOperator
from curvlinops_tpu_torch.curvature.ggn_diagonal import GGNDiagonalLinearOperator
from curvlinops_tpu_torch.curvature.held import HeldLinearizationOperator
from curvlinops_tpu_torch.curvature.hessian import HessianLinearOperator
from curvlinops_tpu_torch.curvature.jacobian import (
    JacobianLinearOperator,
    TransposedJacobianLinearOperator,
)
from curvlinops_tpu_torch.curvature.loss_hessian import FisherType, KFACType
from curvlinops_tpu_torch.estimators.diagonal import hutchinson_diag, xdiag
from curvlinops_tpu_torch.estimators.norm import hutchinson_squared_fro
from curvlinops_tpu_torch.estimators.slq import slq_function_trace, slq_logdet
from curvlinops_tpu_torch.estimators.trace import hutchinson_trace, hutchpp_trace, xtrace
from curvlinops_tpu_torch.kfac.ekfac import EKFACLinearOperator
from curvlinops_tpu_torch.kfac.kfoc import KFOCLinearOperator
from curvlinops_tpu_torch.kfac.operator import KFACLinearOperator
from curvlinops_tpu_torch.losses import BCEWithLogitsLoss, CrossEntropyLoss, MSELoss
from curvlinops_tpu_torch.models.gpt import GPTConfig, shakespeare_nanogpt
from curvlinops_tpu_torch.models.resnet import cifar10_resnet18
from curvlinops_tpu_torch.models.vit import ViTConfig, cifar10_vit
from curvlinops_tpu_torch.ops.base import (
    ChainLinearOperator,
    LinearOperator,
    PytreeLinearOperator,
    ScaledLinearOperator,
    SumLinearOperator,
)
from curvlinops_tpu_torch.ops.blockdiag import BlockDiagonalLinearOperator
from curvlinops_tpu_torch.ops.dense import (
    IdentityLinearOperator,
    MatrixLinearOperator,
    OuterProductLinearOperator,
)
from curvlinops_tpu_torch.ops.diagonal import DiagonalLinearOperator
from curvlinops_tpu_torch.ops.eigh import EighDecomposedLinearOperator
from curvlinops_tpu_torch.ops.inverse import (
    CGInverseLinearOperator,
    LSMRInverseLinearOperator,
    MINRESInverseLinearOperator,
    NeumannInverseLinearOperator,
)
from curvlinops_tpu_torch.ops.kronecker import KroneckerProductLinearOperator
from curvlinops_tpu_torch.ops.submatrix import SubmatrixLinearOperator
from curvlinops_tpu_torch.parallel import make_mesh, shard_params
from curvlinops_tpu_torch.risk import CurvatureLinearOperator, EmpiricalRiskOperator
from curvlinops_tpu_torch.solvers.eigsh import topk_eigenpairs
from curvlinops_tpu_torch.solvers.lanczos import (
    LanczosApproximateLogSpectrumCached,
    LanczosApproximateSpectrumCached,
    lanczos_approximate_log_spectrum,
    lanczos_approximate_spectrum,
    lanczos_eigsh,
)
from curvlinops_tpu_torch.utils.misc import make_functional_call
from curvlinops_tpu_torch.utils.prefetch import PrefetchToDevice, prefetch_to_device

__all__ = [
    "examples",
    "EmpiricalRiskOperator",
    "CurvatureLinearOperator",
    "HessianLinearOperator",
    "GGNLinearOperator",
    "EFLinearOperator",
    "JacobianLinearOperator",
    "TransposedJacobianLinearOperator",
    "HeldLinearizationOperator",
    "GGNDiagonalLinearOperator",
    "FisherType",
    "KFACType",
    "KFACLinearOperator",
    "EKFACLinearOperator",
    "KFOCLinearOperator",
    "MSELoss",
    "CrossEntropyLoss",
    "BCEWithLogitsLoss",
    "LinearOperator",
    "PytreeLinearOperator",
    "SumLinearOperator",
    "ScaledLinearOperator",
    "ChainLinearOperator",
    "MatrixLinearOperator",
    "IdentityLinearOperator",
    "OuterProductLinearOperator",
    "DiagonalLinearOperator",
    "BlockDiagonalLinearOperator",
    "KroneckerProductLinearOperator",
    "EighDecomposedLinearOperator",
    "SubmatrixLinearOperator",
    "CGInverseLinearOperator",
    "LSMRInverseLinearOperator",
    "MINRESInverseLinearOperator",
    "NeumannInverseLinearOperator",
    # spectral properties
    "lanczos_approximate_spectrum",
    "lanczos_approximate_log_spectrum",
    "lanczos_eigsh",
    "LanczosApproximateSpectrumCached",
    "LanczosApproximateLogSpectrumCached",
    "topk_eigenpairs",
    # estimators
    "hutchinson_trace",
    "hutchpp_trace",
    "xtrace",
    "hutchinson_diag",
    "xdiag",
    "hutchinson_squared_fro",
    "slq_function_trace",
    "slq_logdet",
    # adapters
    "make_functional_call",
    "PrefetchToDevice",
    "prefetch_to_device",
    "make_mesh",
    "shard_params",
    "GPTConfig",
    "ViTConfig",
    "shakespeare_nanogpt",
    "cifar10_vit",
    "cifar10_resnet18",
]
