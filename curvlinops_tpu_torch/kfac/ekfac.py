"""EKFAC: eigenvalue-corrected KFAC.

PyTorch counterpart of ``curvlinops_tpu/kfac/ekfac.py``. After the KFAC
factor pass (:meth:`KFACComputer.compute`, with the conv kernel on its
``use_kernel`` route), each factor is eigendecomposed and a second data pass
accumulates the corrected eigenvalues ``lambda = sum_{v,n} (Q_g^T P_vn
Q_a)^2``, the Frobenius-optimal diagonal in the Kronecker eigenbasis
(George et al., 2018). The second pass reuses the factor pass's tapped
forward and batched backward (:meth:`KFACComputer._layer_grads`); the
contraction strategy (per-example gradients or Gramians) is chosen per group
by :func:`curvlinops_tpu_torch.kfac.math.eigenvalue_correction`.

With ``rank`` given, groups with a factor larger than ``rank`` take
randomized partial bases (:func:`~curvlinops_tpu_torch.kfac.randomized.batched_randomized_eigh`)
and the correction pass accumulates the four sector sums of
:func:`~curvlinops_tpu_torch.kfac.randomized.lr_sector_stats` instead of the
full ``[D1, D2]`` grid.

Under ``mesh=`` the eigendecompositions split each shape's stack over the
mesh's data axis (:func:`~curvlinops_tpu_torch.kfac.chain.batched_eigh`,
:func:`~curvlinops_tpu_torch.kfac.randomized.batched_randomized_eigh`), and
the correction pass runs on each process's slices and is summed once.

A scan-stacked group eigendecomposes its ``[L, d, d]`` factors batched and
corrects slice by slice (``"seigh"`` blocks, ``"slreigh"`` at rank ``r``).
An embedding group keeps the identity basis of its diagonal input factor
(no ``eigh`` of it, no rank-``r`` route) and corrects by a segment sum over
token ids (``"eighd"`` blocks,
:func:`~curvlinops_tpu_torch.kfac.math.eigenvalue_correction_embedding`);
a lookup inside a scan loop is refused, as in the JAX package.
"""

from __future__ import annotations

import torch

from curvlinops_tpu_torch.curvature.loss_hessian import FisherType
from curvlinops_tpu_torch.kfac import math as kmath
from curvlinops_tpu_torch.kfac.chain import KroneckerChainOperator, batched_eigh
from curvlinops_tpu_torch.kfac.computer import KFACComputer
from curvlinops_tpu_torch.kfac.operator import KFACLinearOperator, make_to_canonical
from curvlinops_tpu_torch.kfac.randomized import (
    batched_randomized_eigh,
    lr_corrected_data,
    lr_map_scales,
    lr_sector_stats,
)


class EKFACComputer(KFACComputer):
    """KFAC computer, factor eigendecomposition and eigenvalue-correction pass.

    :meth:`compute_ekfac` runs the three phases in turn: :meth:`compute`
    (the factors), :meth:`eigenbases` and :meth:`correction_pass`.

    Raises:
        ValueError: For a ``rank`` that is not a positive int, a Fisher type
            other than type-2, MC or empirical, an embedding lookup inside a
            scan loop, or a model output that is not 2d.
    """

    _SUPPORTED_FISHER = (FisherType.TYPE2, FisherType.MC, FisherType.EMPIRICAL)

    def __init__(
        self,
        *args,
        force_strategy: str | None = None,
        rank: int | None = None,
        rank_power_iters: int = 1,
        rank_key: torch.Generator | None = None,
        **kwargs,
    ):
        super().__init__(*args, **kwargs)
        if rank is not None and (not isinstance(rank, int) or rank <= 0):
            raise ValueError(f"rank must be a positive int, got {rank!r}.")
        self.rank, self.rank_power_iters, self.rank_key = rank, rank_power_iters, rank_key
        if self.fisher_type not in self._SUPPORTED_FISHER:
            raise ValueError(
                f"EKFAC supports fisher types {self._SUPPORTED_FISHER}, got {self.fisher_type}."
            )
        if any(g.input_diag and "scan" in g.uses[0].meta for g in self.groups):
            raise ValueError(
                "EKFAC does not support embedding lookups inside a scan; use "
                "KFAC or hoist the lookup out of the scan."
            )
        self.require_batch_major("EKFAC's eigenvalue correction")
        # per-sample gradients need independent per-datum loss terms
        pred_shape = self._get_traced(self.first_input()).output_shape
        if len(pred_shape) != 2:
            raise ValueError(f"EKFAC supports 2d model output only, got shape {pred_shape}.")
        self._force_strategy = force_strategy
        self.lr_groups: set = set()

    def compute_ekfac(self) -> tuple[dict, dict, dict, list]:
        """Return ``(Q_a, Q_g, corrected_eigenvalues, groups)``."""
        aaT, ggT, groups = self.compute()
        Q_a, Q_g = self.eigenbases(aaT, ggT)
        del aaT, ggT  # only the bases are needed from here on
        return Q_a, Q_g, self.correction_pass(Q_a, Q_g), groups

    def eigenbases(self, aaT: dict, ggT: dict) -> tuple[dict, dict]:
        """Eigenvectors of every factor: batched ``eigh``, or randomized
        rank-``r`` bases for the groups with a factor larger than ``rank``
        (recorded in :attr:`lr_groups`). An embedding group's diagonal input
        factor has the identity basis and gets no ``Q_a`` entry."""
        diag = {gi for gi, g in enumerate(self.groups) if g.input_diag}
        lr_groups = set()
        if self.rank is not None:
            for gi in ggT:  # bias-only groups have no aaT entry
                dims = [ggT[gi].shape[-1]] + ([aaT[gi].shape[-1]] if gi in aaT else [])
                if gi not in diag and max(dims) > self.rank:
                    lr_groups.add(gi)
        self.lr_groups = lr_groups
        mesh = dict(mesh=self.mesh, data_axis=self.data_axis)
        eig_a = batched_eigh(
            {gi: v for gi, v in aaT.items() if gi not in lr_groups and gi not in diag}, **mesh
        )
        eig_g = batched_eigh({gi: v for gi, v in ggT.items() if gi not in lr_groups}, **mesh)
        Q_a = {gi: Q for gi, (_, Q) in eig_a.items()}
        Q_g = {gi: Q for gi, (_, Q) in eig_g.items()}
        if lr_groups:
            lr_mats = {
                (gi, side): mats[gi]
                for gi in sorted(lr_groups)
                for side, mats in (("a", aaT), ("g", ggT))
                if gi in mats
            }
            reig = batched_randomized_eigh(
                lr_mats, self.rank, self.rank_key, self.rank_power_iters, **mesh
            )
            for gi in lr_groups:  # partial bases only: the pass recomputes the spectra
                if (gi, "a") in reig:
                    Q_a[gi] = reig[(gi, "a")][1]
                Q_g[gi] = reig[(gi, "g")][1]
        return Q_a, Q_g

    def correction_pass(self, Q_a: dict, Q_g: dict) -> dict:
        """Second data pass: per group the corrected eigenvalues (a tensor),
        or for a rank-``r`` group its four accumulated sector sums."""
        lambdas: dict = {}
        for X, y, gen, corr_eff in self.batches():
            pred, inputs, deltas, _ = self._get_traced(X).apply_with_io(self.params, X)
            grads = self._layer_grads(pred, deltas, y, gen)
            for gi, group in enumerate(self.groups):
                parts = [
                    self._slice_correction(inputs, grads, group, gi, uses, Q_a, Q_g, corr_eff, l)
                    for l, uses in enumerate(self.slices(group))
                ]
                lam = self.stack_slices(group, parts)
                if gi in lambdas:
                    old = lambdas[gi]
                    lam = tuple(map(torch.add, old, lam)) if isinstance(lam, tuple) else old + lam
                lambdas[gi] = lam
            del pred, inputs, deltas, grads
        return self._shards.all_reduce(lambdas)

    def _slice_correction(self, inputs, grads, group, gi, uses, Q_a, Q_g, corr_eff, l):
        """One Kronecker block's corrected eigenvalues from one batch (slice
        ``l`` of a stacked group's bases), or its four sector sums."""
        Qg = Q_g[gi][l] if group.stack else Q_g[gi]
        g = self._group_grads(grads, uses).to(Qg.dtype)  # the bases' dtype
        if group.input_diag:
            idx = self._group_inputs(inputs, group, uses)
            return corr_eff * kmath.eigenvalue_correction_embedding(g, Qg, idx, group.d_in)
        if group.weight_path is None:
            a, Qa = None, None
            if gi in self.lr_groups:
                # the bias "input" is the constant 1: a one-dim a-basis
                a, Qa = g.new_ones(g.shape[1:3] + (1,)), g.new_ones((1, 1))
        else:
            a = self._group_inputs(inputs, group, uses).to(g.dtype)
            Qa = Q_a[gi][l] if group.stack else Q_a[gi]
        if gi in self.lr_groups:
            return tuple(corr_eff * t for t in lr_sector_stats(g, Qg, a, Qa))
        return corr_eff * kmath.eigenvalue_correction(g, Qg, a, Qa, self._force_strategy)


class EKFACLinearOperator(KFACLinearOperator):
    """EKFAC: eigendecomposed canonical blocks with corrected spectra.

    A canonical block is ``EighDecomposed(lambda, Kron(Q_g, Q_a))``;
    ``inverse(damping)`` is ``1 / (lambda + delta)`` in the same basis.

    Keyword arguments are :class:`EKFACComputer`'s: those of
    :class:`~curvlinops_tpu_torch.kfac.computer.KFACComputer` and
    ``force_strategy``, ``rank``, ``rank_power_iters`` and ``rank_key``.
    With ``rank=r``, groups with a factor larger than ``r`` use randomized
    partial eigenbases and 4-sector corrected spectra
    (:mod:`curvlinops_tpu_torch.kfac.randomized`); ``rank >= D`` reproduces
    the exact path, and a rank above the factors' true rank is exact up to
    roundoff whatever the test matrix.
    """

    def __init__(self, model: torch.nn.Module, loss_fn, params: dict, data, **kwargs):
        computer = EKFACComputer(model, loss_fn, params, data, **kwargs)
        Q_a, Q_g, lambdas, groups = computer.compute_ekfac()
        self._params, self._groups = computer.params, groups
        self._Q_a, self._Q_g, self._lambdas = Q_a, Q_g, lambdas
        self._rebuild_chain()
        self._computer = computer

    def _rebuild_chain(self) -> None:
        blocks_data = {}
        for gi, group in enumerate(self._groups):
            lam = self._lambdas[gi]
            if isinstance(lam, (tuple, list)):
                # rank-r group: accumulated sector sums -> sector spectra; a
                # bias-only group carries a trivial one-dim a-basis
                Qg = self._Q_g[gi]
                Qa = self._Q_a.get(gi, Qg.new_ones((*Qg.shape[:-2], 1, 1)))
                kind = "slreigh" if group.stack else "lreigh"
                blocks_data[gi] = (kind, lr_corrected_data(Qg, Qa, tuple(lam)))
                continue
            if group.input_diag:
                blocks_data[gi] = ("eighd", (lam.reshape(group.d_out, group.d_in), self._Q_g[gi]))
                continue
            Qs = [self._Q_g[gi]] + ([self._Q_a[gi]] if gi in self._Q_a else [])
            if group.stack:
                blocks_data[gi] = ("seigh", (lam.reshape(group.stack, -1), Qs))
            else:
                blocks_data[gi] = ("eigh", (lam.reshape(-1), Qs))
        to_canonical, from_canonical = make_to_canonical(self._groups, self._params)
        KroneckerChainOperator.__init__(
            self, self._params, blocks_data, to_canonical, from_canonical
        )

    @property
    def corrected_eigenvalues(self) -> dict:
        """Per-group corrected eigenvalues; rank-``r`` groups hold their
        accumulated sector sums ``(lam11, row_g, col_a, total)``."""
        return self._lambdas

    def inverse(self, damping: float = 0.0) -> KroneckerChainOperator:
        """Damped inverse ``1 / (lambda + delta)`` in the Kronecker eigenbasis
        (sector blocks invert in their sector decomposition)."""
        blocks_data = {}
        for gi in sorted(self._blocks_data):
            kind, payload = self._blocks_data[gi]
            if kind in ("lreigh", "slreigh"):
                blocks_data[gi] = (kind, lr_map_scales(payload, lambda s: 1.0 / (s + damping)))
            else:
                lam, Qs = payload
                blocks_data[gi] = (kind, (1.0 / (lam + damping), Qs))
        return KroneckerChainOperator(
            self._params, blocks_data, self._to_canonical, self._from_canonical
        )

    def state_dict(self) -> dict:
        """Eigenbases and corrected eigenvalues, keyed by group index."""
        return {
            "Q_a": {str(k): v for k, v in self._Q_a.items()},
            "Q_g": {str(k): v for k, v in self._Q_g.items()},
            "lambdas": {str(k): v for k, v in self._lambdas.items()},
        }

    def load_state_dict(self, state: dict) -> None:
        """Restore eigenbases and eigenvalues and rebuild the chain (drops the
        cached programs)."""
        self._Q_a = {int(k): v for k, v in state["Q_a"].items()}
        self._Q_g = {int(k): v for k, v in state["Q_g"].items()}
        self._lambdas = {
            int(k): tuple(v) if isinstance(v, (tuple, list)) else v
            for k, v in state["lambdas"].items()
        }
        self._rebuild_chain()
        self.invalidate_traced()

    @classmethod
    def from_state_dict(
        cls, state: dict, model: torch.nn.Module, loss_fn, params, data, **kwargs
    ) -> "EKFACLinearOperator":
        """Rebuild from stored eigenbases and eigenvalues without the two
        data passes (``data`` is traced once; determinism checking defaults
        to off)."""
        kwargs.setdefault("check_deterministic", False)
        self = cls.__new__(cls)
        computer = EKFACComputer(model, loss_fn, params, data, **kwargs)
        self._computer = computer
        self._params, self._groups = computer.params, computer.groups
        self.load_state_dict(state)
        return self
