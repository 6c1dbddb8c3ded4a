"""KFAC linear operator: ``P @ K @ P^T`` over a dict of named parameters.

PyTorch counterpart of ``curvlinops_tpu/kfac/operator.py``. The
Kronecker-factored curvature lives in a canonical per-group space (flattened
``[d_out, d_in(+1)]`` blocks; ``[L, d_out, d_in(+1)]`` for a scan-stacked
group, ``[C, V]`` for an embedding table); the canonical converters are
permutations between the parameter dict and that space, so each is the
other's adjoint. A group's block kind follows its layout: ``"kron"``,
``"skron"`` (stacked) or ``"krond"`` (embedding, a diagonal input factor).

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
    stacked_kron_inverse,
)
from curvlinops_tpu_torch.kfac.computer import KFACComputer, ParamGroup
from curvlinops_tpu_torch.kfac.randomized import batched_randomized_eigh, lr_damped_inverse_data
from curvlinops_tpu_torch.ops.blockdiag import BlockDiagonalLinearOperator
from curvlinops_tpu_torch.ops.kronecker import (
    EmbeddingKroneckerOperator,
    KroneckerProductLinearOperator,
)


def damped_eig_assembly(
    eig: dict, reig: dict, diag: dict, damping: float, struct: list
) -> dict:
    """Every exact and rank-``r`` damped-inverse block in one pass.

    ``struct`` lists ``(gi, kind, n_factors, mode)`` with ``kind`` the
    block's (``"kron"``, ``"skron"``, ``"krond"``) and ``mode`` ``"lr"``
    (the 4-sector inverse of ``reig[(gi, 0)]`` and ``reig[(gi, 1)]``),
    ``"krond"`` (``1 / (lam_G d^T + damping)`` in ``G``'s eigenbasis, ``d``
    from ``diag[gi]``) or ``"eig"`` (``1 / (kron(eigenvalues) + damping)``
    in the Kronecker eigenbasis of ``eig[(gi, fi)]``, per stack slice for
    ``"skron"``).

    Returns:
        ``{gi: (block kind, data)}`` chain blocks: ``"lreigh"``/``"slreigh"``,
        ``"eighd"``, or ``"eigh"``/``"seigh"``.
    """
    out = {}
    for gi, kind, n_factors, mode in struct:
        stacked = kind == "skron"
        if mode == "lr":
            data = lr_damped_inverse_data(reig[(gi, 0)], reig[(gi, 1)], damping)
            out[gi] = ("slreigh" if stacked else "lreigh", data)
            continue
        if mode == "krond":
            lam_G, Q_G = eig[(gi, 0)]
            out[gi] = ("eighd", (1.0 / (lam_G[:, None] * diag[gi][None, :] + damping), Q_G))
            continue
        lam = eig[(gi, 0)][0]
        for fi in range(1, n_factors):
            lam = (lam[..., :, None] * eig[(gi, fi)][0][..., None, :]).flatten(-2)
        Qs = [eig[(gi, fi)][1] for fi in range(n_factors)]
        out[gi] = ("seigh" if stacked else "eigh", (1.0 / (lam + damping), Qs))
    return out


def make_to_canonical(
    groups: list[ParamGroup], params: dict[str, torch.Tensor]
) -> tuple[Callable[[dict], tuple], Callable[[tuple], dict]]:
    """Maps between the parameter dict and the tuple of flat canonical blocks.

    Both maps accept trailing (column) axes on every tensor.
    """
    names = list(params)
    ndims = {n: p.ndim for n, p in params.items()}

    def flat(t: torch.Tensor, ndim: int) -> torch.Tensor:
        return t.reshape(-1, *t.shape[ndim:])

    def to_canonical(v: dict) -> tuple:
        blocks = []
        for group in groups:
            if group.weight_path is None:
                bp = group.bias_path
                blocks.append(flat(v[bp], ndims[bp]))  # [(L *) d_out, *cols]
                continue
            W, kind = v[group.weight_path], group.uses[0].kind
            if kind == "conv":
                canon = kmath.canonical_conv_weight(W, group.uses[0].meta)
            elif kind == "embedding":
                canon = kmath.canonical_embedding_weight(W)
            else:  # dense, also stacked [L, d_out, d_in]
                canon = kmath.canonical_dense_weight(W, group.uses[0].meta)
            if group.joint:
                bp, lead = group.bias_path, (group.stack,) if group.stack else ()
                b = v[bp].reshape(*lead, group.d_out, *v[bp].shape[ndims[bp]:])
                canon = torch.cat([canon, b.unsqueeze(len(lead) + 1)], dim=len(lead) + 1)
            blocks.append(flat(canon, 3 if group.stack else 2))
        return tuple(blocks)

    def from_canonical(blocks: tuple) -> dict:
        out = {}
        for group, block in zip(groups, blocks):
            cols = block.shape[1:]
            if group.weight_path is None:
                out[group.bias_path] = block.reshape(*params[group.bias_path].shape, *cols)
                continue
            lead = (group.stack,) if group.stack else ()
            mat = block.reshape(*lead, group.d_out, group.d_in, *cols)
            last = len(lead) + 1  # the d_in axis
            if group.joint:
                bias = mat.select(last, -1)
                out[group.bias_path] = bias.reshape(*params[group.bias_path].shape, *cols)
                mat = mat.narrow(last, 0, group.d_in - 1)
            use = group.uses[0]
            if use.kind == "conv":
                out[group.weight_path] = kmath.canonical_conv_weight_inverse(mat, use.meta)
            elif use.kind == "embedding":
                out[group.weight_path] = kmath.canonical_embedding_weight_inverse(mat)
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
    ``kfac_approx`` is ``expand`` or ``reduce``. ``use_kernel`` routes
    eligible conv input covariances through the Hopper kernel under EXPAND
    (``"auto"``: iff the parameters are on a CUDA device). ``mesh`` and
    ``data_axis`` split the factor pass over a mesh axis
    (:class:`~curvlinops_tpu_torch.kfac.computer.KFACComputer`), and the
    exact-damped and rank-``r`` inverses split their eigendecompositions
    over it.
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
        mesh=None,
        data_axis: str = "data",
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
            mesh=mesh,
            data_axis=data_axis,
        )
        aaT, ggT, groups = computer.compute()
        self._build_from_factors(computer.params, groups, aaT, ggT)
        self._computer = computer

    def _build_from_factors(self, params, groups, aaT, ggT) -> None:
        blocks_data = {
            gi: (
                "krond" if group.input_diag else "skron" if group.stack else "kron",
                [ggT[gi]] + ([aaT[gi]] if gi in aaT else []),
            )
            for gi, group in enumerate(groups)
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
        rank_power_iters: int = 1,
        rank_key: torch.Generator | None = None,
    ) -> KroneckerChainOperator:
        """Damped inverse: invert each block and rebuild the chain.

        Plain and heuristic damping invert the Kronecker factors (batched
        Cholesky, per-block float64 retry when one fails); exact damping
        eigendecomposes them and inverts ``kron(eigvals) + delta``.

        With ``rank`` (requires ``use_exact_damping=True``), a block with a
        factor larger than ``rank`` takes a randomized rank-``r``
        eigendecomposition of its factors with a trace-preserving tail
        (:mod:`curvlinops_tpu_torch.kfac.randomized`; ``"slreigh"`` for a
        stacked block); a bias-only block rides the same route with a
        trivial ``[1, 1]`` second factor (``kron(S, [[1]]) == S``). Smaller
        blocks keep the exact ``eigh``, and ``rank >= D`` reproduces the
        exact inverse. An embedding block always takes the exact ``eigh`` of
        its ``[C, C]`` factor; its diagonal factor is its own spectrum. ``rank_key`` is the
        ``torch.Generator`` that draws the test matrices (the JAX package's
        key); the default, a CPU generator seeded 0, makes repeated builds
        identical on any device.

        Raises:
            ValueError: When both heuristic and exact damping are requested,
                or when ``rank`` is given without ``use_exact_damping`` or is
                not a positive int.
        """
        if use_heuristic_damping and use_exact_damping:
            raise ValueError("Choose either heuristic or exact damping, not both.")
        if rank is not None:
            if not use_exact_damping:
                raise ValueError(
                    "rank= requires use_exact_damping=True (plain/heuristic "
                    "damping needs no eigendecomposition to begin with)."
                )
            if not isinstance(rank, int) or rank <= 0:
                raise ValueError(f"rank must be a positive int, got {rank!r}.")
        if use_exact_damping:
            flat, flat_rand, diag, struct = {}, {}, {}, []
            for gi in sorted(self._blocks_data):
                kind, fs = self._blocks_data[gi]
                if kind == "krond":
                    flat[(gi, 0)], diag[gi] = fs
                    struct.append((gi, kind, 2, "krond"))
                    continue
                if rank is not None and max(S.shape[-1] for S in fs) > rank:
                    S = fs[0]
                    flat_rand[(gi, 0)] = S
                    flat_rand[(gi, 1)] = fs[1] if len(fs) == 2 else S.new_ones((*S.shape[:-2], 1, 1))
                    struct.append((gi, kind, 2, "lr"))
                    continue
                for fi, S in enumerate(fs):
                    flat[(gi, fi)] = S
                struct.append((gi, kind, len(fs), "eig"))
            computer = getattr(self, "_computer", None)
            mesh = dict(
                mesh=getattr(computer, "mesh", None),
                data_axis=getattr(computer, "data_axis", "data"),
            )
            eig = batched_eigh(flat, **mesh)
            reig = (
                batched_randomized_eigh(flat_rand, rank, rank_key, rank_power_iters, **mesh)
                if flat_rand else {}
            )
            blocks_data = damped_eig_assembly(eig, reig, diag, damping, struct)
        else:
            blocks_data = {}
            inv = grouped_kron_inverse(
                {gi: v for gi, v in self._blocks_data.items() if v[0] != "krond"},
                damping, use_heuristic_damping, min_damping,
            )
            for gi, (kind, fs) in self._blocks_data.items():
                if kind == "krond":
                    block = EmbeddingKroneckerOperator(*fs).inverse(
                        damping=damping,
                        use_heuristic_damping=use_heuristic_damping,
                        min_damping=min_damping,
                        retry_double_precision=retry_double_precision,
                    )
                    blocks_data[gi] = (kind, block.factors)
                elif inv is not None:
                    blocks_data[gi] = (kind, inv[gi])
                elif kind == "skron":
                    blocks_data[gi] = (kind, stacked_kron_inverse(
                        fs, damping, use_heuristic_damping, min_damping, retry_double_precision,
                    ))
                else:
                    block = KroneckerProductLinearOperator(*fs).inverse(
                        damping=damping,
                        use_heuristic_damping=use_heuristic_damping,
                        min_damping=min_damping,
                        retry_double_precision=retry_double_precision,
                    )
                    blocks_data[gi] = (kind, block.factors)
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
        """Restore factors and rebuild the chain (drops the cached programs)."""
        aaT = {int(k): v for k, v in state["aaT"].items()}
        ggT = {int(k): v for k, v in state["ggT"].items()}
        self._build_from_factors(self._params, self._groups, aaT, ggT)
        self.invalidate_traced()

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
        self._params, self._groups = computer.params, computer.groups
        self.load_state_dict(state)
        return self
