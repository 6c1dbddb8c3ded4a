"""KFAC linear operator: ``P @ K @ P^T`` over a dict of named parameters.

PyTorch counterpart of ``curvlinops_tpu/kfac/operator.py``. The
Kronecker-factored curvature lives in a canonical per-group space (flattened
``[d_out, d_in(+1)]`` blocks); the canonical converters are permutations
between the parameter dict and that space, so each is the other's adjoint.

Example:
    >>> import torch
    >>> from torch import nn
    >>> from curvlinops_tpu_torch.kfac.operator import KFACLinearOperator
    >>> from curvlinops_tpu_torch.losses import MSELoss
    >>> model = nn.Linear(4, 3, bias=False)
    >>> X, y = torch.rand(1, 4), torch.rand(1, 3)
    >>> kfac = KFACLinearOperator(model, MSELoss("sum"), dict(model.named_parameters()),
    ...                           [(X, y)], fisher_type="type-2")
    >>> v = torch.randn(12)
    >>> inv = kfac.inverse(damping=1e-1, use_exact_damping=True)
    >>> bool(torch.allclose(inv @ (kfac @ v + 1e-1 * v), v, atol=1e-4))
    True
"""

from __future__ import annotations

from typing import Callable

import torch

from curvlinops_tpu_torch.curvature.loss_hessian import FisherType, KFACType
from curvlinops_tpu_torch.kfac import math as kmath
from curvlinops_tpu_torch.kfac.chain import (
    KroneckerChainOperator,
    batched_eigh,
    grouped_kron_inverse,
)
from curvlinops_tpu_torch.kfac.computer import KFACComputer, ParamGroup
from curvlinops_tpu_torch.ops.blockdiag import BlockDiagonalLinearOperator
from curvlinops_tpu_torch.ops.kronecker import KroneckerProductLinearOperator


def make_to_canonical(
    groups: list[ParamGroup], params: dict[str, torch.Tensor]
) -> tuple[Callable[[dict], tuple], Callable[[tuple], dict]]:
    """Maps between the parameter dict and the tuple of flat canonical blocks.

    Both maps accept trailing (column) axes on every tensor.
    """
    names = list(params)

    def to_canonical(v: dict) -> tuple:
        blocks = []
        for group in groups:
            if group.weight_path is None:
                blocks.append(v[group.bias_path])  # [d_out, *cols]
                continue
            W = v[group.weight_path]
            if group.uses[0].kind == "conv":
                canon = kmath.canonical_conv_weight(W)
            else:
                canon = kmath.canonical_dense_weight(W)
            if group.joint:
                canon = torch.cat([canon, v[group.bias_path].unsqueeze(1)], dim=1)
            blocks.append(canon.reshape(-1, *canon.shape[2:]))
        return tuple(blocks)

    def from_canonical(blocks: tuple) -> dict:
        out = {}
        for group, block in zip(groups, blocks):
            if group.weight_path is None:
                out[group.bias_path] = block
                continue
            mat = block.reshape(group.d_out, group.d_in, *block.shape[1:])
            if group.joint:
                out[group.bias_path] = mat[:, -1]
                mat = mat[:, :-1]
            use = group.uses[0]
            if use.kind == "conv":
                out[group.weight_path] = kmath.canonical_conv_weight_inverse(mat, use.meta)
            else:
                out[group.weight_path] = kmath.canonical_dense_weight_inverse(mat, use.meta)
        missing = [n for n in names if n not in out]
        if missing:
            raise ValueError(f"Groups do not cover parameters: {missing}.")
        return {n: out[n] for n in names}

    return to_canonical, from_canonical


class KFACLinearOperator(KroneckerChainOperator):
    r"""Kronecker-factored approximate curvature of the Fisher/GGN.

    ``KFAC = FromCanonical @ blockdiag(ggT_i (x) aaT_i) @ ToCanonical``.
    ``fisher_type`` is one of type-2, mc, empirical and forward-only;
    ``kfac_approx`` must be ``expand`` (REDUCE is not ported yet).
    ``use_kernel`` routes eligible conv input covariances through the
    Hopper kernel (``"auto"``: iff the parameters are on a CUDA device).
    """

    SELF_ADJOINT = True

    def __init__(
        self,
        model: torch.nn.Module,
        loss_fn,
        params: dict[str, torch.Tensor],
        data,
        *,
        fisher_type: str = FisherType.MC,
        mc_samples: int = 1,
        kfac_approx: str = KFACType.EXPAND,
        separate_weight_and_bias: bool = True,
        num_data: int | None = None,
        num_per_example_loss_terms: int | None = None,
        seed: int = 2147483647,
        batch_size_fn: Callable | None = None,
        check_deterministic: bool = True,
        use_kernel: str | bool = "auto",
    ):
        computer = KFACComputer(
            model, loss_fn, params, data,
            fisher_type=fisher_type,
            mc_samples=mc_samples,
            kfac_approx=kfac_approx,
            separate_weight_and_bias=separate_weight_and_bias,
            num_data=num_data,
            num_per_example_loss_terms=num_per_example_loss_terms,
            seed=seed,
            batch_size_fn=batch_size_fn,
            check_deterministic=check_deterministic,
            use_kernel=use_kernel,
        )
        aaT, ggT, groups = computer.compute()
        self._build_from_factors(params, groups, aaT, ggT)
        self._computer = computer

    def _build_from_factors(self, params, groups, aaT, ggT) -> None:
        blocks_data = {
            gi: ("kron", [ggT[gi]] + ([aaT[gi]] if gi in aaT else []))
            for gi in range(len(groups))
        }
        to_canonical, from_canonical = make_to_canonical(groups, params)
        KroneckerChainOperator.__init__(self, params, blocks_data, to_canonical, from_canonical)
        self._params, self._groups = params, groups
        self._aaT, self._ggT = aaT, ggT

    @property
    def groups(self) -> list[ParamGroup]:
        """The canonical parameter groups (one per Kronecker block)."""
        return self._groups

    @property
    def canonical(self) -> BlockDiagonalLinearOperator:
        """The block-diagonal operator in the canonical basis."""
        return self.ops[1]

    def trace(self) -> torch.Tensor:
        """Exact trace (the basis change preserves it)."""
        return self.canonical.trace()

    def det(self) -> torch.Tensor:
        """Exact determinant."""
        return self.canonical.det()

    def logdet(self) -> torch.Tensor:
        """Exact log-determinant."""
        return self.canonical.logdet()

    def frobenius_norm(self) -> torch.Tensor:
        """Exact Frobenius norm."""
        return self.canonical.frobenius_norm()

    def inverse(
        self,
        damping: float = 0.0,
        use_heuristic_damping: bool = False,
        min_damping: float = 1e-8,
        use_exact_damping: bool = False,
        retry_double_precision: bool = True,
        rank: int | None = None,
    ) -> KroneckerChainOperator:
        """Damped inverse: invert each block and rebuild the chain.

        Plain and heuristic damping invert the Kronecker factors (batched
        Cholesky, per-block float64 retry when one fails); exact damping
        eigendecomposes them and inverts ``kron(eigvals) + delta``.

        Raises:
            ValueError: When both heuristic and exact damping are requested.
            NotImplementedError: For ``rank=`` (the randomized inverse is
                not ported yet).
        """
        if use_heuristic_damping and use_exact_damping:
            raise ValueError("Choose either heuristic or exact damping, not both.")
        if rank is not None:
            raise NotImplementedError("rank= (randomized inverse) is not ported yet.")
        blocks_data = {}
        if use_exact_damping:
            eig = batched_eigh(
                {
                    (gi, fi): S
                    for gi, (_, fs) in self._blocks_data.items()
                    for fi, S in enumerate(fs)
                }
            )
            for gi, (_, fs) in self._blocks_data.items():
                lam = eig[(gi, 0)][0]
                for fi in range(1, len(fs)):
                    lam = torch.kron(lam, eig[(gi, fi)][0])
                Qs = [eig[(gi, fi)][1] for fi in range(len(fs))]
                blocks_data[gi] = ("eigh", (1.0 / (lam + damping), Qs))
        else:
            inv = grouped_kron_inverse(
                self._blocks_data, damping, use_heuristic_damping, min_damping
            )
            for gi, (_, fs) in self._blocks_data.items():
                if inv is not None:
                    blocks_data[gi] = ("kron", inv[gi])
                    continue
                block = KroneckerProductLinearOperator(*fs).inverse(
                    damping=damping,
                    use_heuristic_damping=use_heuristic_damping,
                    min_damping=min_damping,
                    retry_double_precision=retry_double_precision,
                )
                blocks_data[gi] = ("kron", block.factors)
        return KroneckerChainOperator(
            self._params, blocks_data, self._to_canonical, self._from_canonical
        )

    def state_dict(self) -> dict:
        """The factors, keyed by group index."""
        return {
            "aaT": {str(k): v for k, v in self._aaT.items()},
            "ggT": {str(k): v for k, v in self._ggT.items()},
        }

    def load_state_dict(self, state: dict) -> None:
        """Restore factors and rebuild the chain."""
        aaT = {int(k): v for k, v in state["aaT"].items()}
        ggT = {int(k): v for k, v in state["ggT"].items()}
        self._build_from_factors(self._params, self._groups, aaT, ggT)

    @classmethod
    def from_state_dict(
        cls, state: dict, model: torch.nn.Module, loss_fn, params, data, **kwargs
    ) -> "KFACLinearOperator":
        """Rebuild an operator from stored factors without recomputing them.

        ``data`` is still traced once for layer discovery and dataset
        statistics; no factor pass runs. Determinism checking defaults to off.
        """
        kwargs.setdefault("check_deterministic", False)
        self = cls.__new__(cls)
        computer = KFACComputer(model, loss_fn, params, data, **kwargs)
        self._computer = computer
        self._params, self._groups = params, computer.groups
        self.load_state_dict(state)
        return self
