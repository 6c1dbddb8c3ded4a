"""KFOC: Frobenius-optimal rank-one Kronecker approximation of the GGN.

PyTorch counterpart of ``curvlinops_tpu/kfac/kfoc.py``. Per weight group,
the best rank-one Kronecker approximation ``S_1 (x) S_2`` of the layer GGN
block ``G = sum_{v,n} vec(P_vn) vec(P_vn)^T`` comes from the top singular
pair of the Van Loan rearrangement ``R(G) vec(M) = vec(sum P M P^T)``,
computed by alternating power iteration on ``R`` / ``R^T`` on the device.
Factors are not symmetrized or PSD-projected. Bias-only groups store the
exact GGN block (the single-factor Frobenius optimum).

The per-sample gradients ``P [V, N, d_out, d_in]`` are materialized, so a
power step costs about ``2 N d_out d_in (d_in + d_out)`` flops per
direction. Scope as in the reference: one batch, ``fisher_type`` type-2 or
MC, EXPAND only. Under ``mesh=`` each process holds the per-sample
gradients of its slice of the batch, every sum over samples in a power step
is summed over the mesh's data axis, and each stopping rule reads the
reduced (replicated) values, so every process stops on the same step.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from curvlinops_tpu_torch.curvature.loss_hessian import FisherType, KFACType
from curvlinops_tpu_torch.kfac.computer import KFACComputer
from curvlinops_tpu_torch.kfac.operator import KFACLinearOperator

_STALL_LIMIT, _IMPROVEMENT = 100, 0.98  # stagnation: < 2% better over 100 steps


def _fro(X: torch.Tensor) -> torch.Tensor:
    """Frobenius norm of each ``[m, n]`` slice of ``X [G, m, n]``."""
    return torch.linalg.matrix_norm(X)


def batched_top_rank_one_kron_factors(
    P: torch.Tensor,
    num_iters: int = 2000,
    tol: float | None = None,
    reduce: Callable[[torch.Tensor], torch.Tensor] | None = None,
) -> tuple[torch.Tensor, torch.Tensor, dict]:
    """:func:`top_rank_one_kron_factors` for a stack of groups of one shape.

    ``P [G, V, N, d_out, d_in]``: each group runs its own recurrence and
    stopping rule; a group that has stopped is masked out of the update, so
    its iterate, iteration count and residual stay what its own loop gives.
    The host reads one flag per step (whether any group is still running).
    ``reduce`` sums each product over samples held elsewhere (the mesh's
    data axis, when ``P`` holds one process's samples).

    Returns:
        ``(S_1 [G, d_out, d_out], S_2 [G, d_in, d_in], info)`` with per-group
        ``info`` tensors ``iterations``, ``residual`` and ``sigma``.
    """
    G, d_out, d_in = P.shape[0], P.shape[3], P.shape[4]
    P = P.reshape(G, -1, d_out, d_in)  # [G, X, d_out, d_in], X = V * N
    if tol is None:
        tol = 10 * torch.finfo(P.dtype).eps
    eps = torch.finfo(P.dtype).tiny
    reduce = reduce or (lambda t: t)

    def R(M):  # [G, d_in, d_in] -> [G, d_out, d_out]: sum_x P_x M P_x^T
        return reduce(torch.einsum("gxor,gxpr->gop", P @ M[:, None], P))

    def RT(U):  # [G, d_out, d_out] -> [G, d_in, d_in]: sum_x P_x^T U P_x
        return reduce(torch.einsum("gxor,gxoc->grc", P, U[:, None] @ P))

    def scale(X, s):
        return X / s.clamp(min=eps)[:, None, None]

    kw = dict(dtype=P.dtype, device=P.device)
    V = torch.eye(d_in, **kw).expand(G, d_in, d_in) / d_in**0.5
    sigma = torch.zeros(G, **kw)
    res = torch.full((G,), float("inf"), **kw)
    best = res.clone()
    k = torch.zeros(G, dtype=torch.long, device=P.device)
    stall = torch.zeros_like(k)

    def running():
        return (k < num_iters) & (res > tol) & (stall < _STALL_LIMIT)

    active = running()
    while bool(active.any()):  # the one host read per step
        U = R(V)
        U = scale(U, _fro(U))
        W = RT(U)
        s = _fro(W)
        # relative singular-pair residual; an exact zero block converges at once
        r = _fro(W - s[:, None, None] * V) / s.clamp(min=eps)
        r = torch.where(s <= eps, 0.0, r)
        improved = r < best * _IMPROVEMENT
        m = active[:, None, None]
        V = torch.where(m, scale(W, s), V)
        sigma = torch.where(active, s, sigma)
        res = torch.where(active, r, res)
        best = torch.where(active & improved, r, best)
        stall = torch.where(active, torch.where(improved, 0, stall + 1), stall)
        k = k + active
        active = running()
    U = R(V)
    U = scale(U, _fro(U))
    root = sigma.sqrt()[:, None, None]  # G = 0 -> sigma = 0 -> zero factors
    info = {"iterations": k, "residual": res, "sigma": sigma}
    return root * U, root * V, info


def top_rank_one_kron_factors(
    P: torch.Tensor, num_iters: int = 2000, tol: float | None = None
) -> tuple[torch.Tensor, torch.Tensor, dict]:
    """Top singular pair of the Van Loan rearrangement, by power iteration.

    The alternating ``R`` / ``R^T`` iteration stops when the relative
    singular-pair residual ``||R^T(U) - sigma V||_F / sigma`` drops to
    ``tol``, at the iteration cap, or on stagnation: less than 2% residual
    improvement over the last 100 steps. The float32 recurrence has a
    residual floor above machine eps that grows with the contraction
    length, so a tolerance alone would either never trigger or have to be
    loosened past what near-degenerate pairs need; the stagnation rule stops
    at the floor wherever it lies. The window is loose on purpose: a
    near-degenerate pair (sigma2/sigma1 = 0.998) improves only ~2% per 50
    steps before its asymptotic rate sets in.

    Args:
        P: Per-sample ``vec(W)`` gradients ``[V, N, d_out, d_in]`` scaled so
            that ``G = sum vec(P) vec(P)^T`` is the layer GGN block.
        num_iters: Iteration cap.
        tol: Relative residual tolerance; default ``10 * eps`` of ``P``'s
            dtype.

    Returns:
        ``(S_1 [d_out, d_out], S_2 [d_in, d_in], info)`` with
        ``S_1 (x) S_2 ~= argmin ||G - S_1 (x) S_2||_F`` (zero blocks for
        ``G = 0``); ``info`` holds ``iterations``, ``residual`` (relative)
        and ``sigma`` as device scalars.
    """
    S_1, S_2, info = batched_top_rank_one_kron_factors(P[None], num_iters, tol)
    return S_1[0], S_2[0], {k: v[0] for k, v in info.items()}


class KFOCComputer(KFACComputer):
    """Single-batch computer for KFOC's per-sample-gradient factors.

    Raises:
        ValueError: For a Fisher type other than type-2 or MC, REDUCE, a
            scan-stacked or embedding group, or more than one batch.
    """

    def __init__(self, *args, power_iters: int = 2000, power_tol: float | None = None, **kwargs):
        kwargs.setdefault("kfac_approx", KFACType.EXPAND)
        self.power_iters, self.power_tol = power_iters, power_tol
        super().__init__(*args, **kwargs)
        if self.fisher_type not in (FisherType.TYPE2, FisherType.MC):
            raise ValueError(f"KFOC supports TYPE2/MC fisher types, got {self.fisher_type}.")
        if self.kfac_approx != KFACType.EXPAND:
            raise ValueError("KFOC supports KFACType.EXPAND only.")
        if any(group.stack for group in self.groups):
            raise ValueError(
                "KFOC does not support scan-stacked layers; unroll the stack or use KFAC/EKFAC."
            )
        if any(group.input_diag for group in self.groups):
            raise ValueError("KFOC does not support embedding layers; use KFAC.")
        self.require_batch_major("KFOC")
        n_batches = sum(1 for _ in self.data)
        if n_batches != 1:
            raise ValueError(f"KFOC requires a single batch, got {n_batches}.")

    def compute_kfoc(self) -> tuple[dict, dict, list]:
        """Return ``({gi: S_2}, {gi: S_1 or the bias block}, groups)`` and set
        :attr:`power_info` (per weight group: ``iterations``, ``residual``,
        ``sigma``).

        Weight groups of one canonical shape run their power iterations
        together (:func:`batched_top_rank_one_kron_factors`).
        """
        X, y, gen, corr_eff = next(self.batches())
        pred, inputs, deltas, _ = self._get_traced(X).apply_with_io(self.params, X)
        grads = self._layer_grads(pred, deltas, y, gen)
        del pred, deltas
        sqrt_corr = corr_eff**0.5
        first, second, infos = {}, {}, {}
        by_shape: dict = {}
        for gi, group in enumerate(self.groups):
            g = self._group_grads(grads, group.uses)  # [V, N, S, d_out]
            if group.weight_path is None:
                Pb = sqrt_corr * g.sum(dim=2)  # [V, N, d_out]
                Pb = Pb.reshape(-1, Pb.shape[-1])
                first[gi] = self._shards.all_reduce(Pb.T @ Pb)
                continue
            a = self._group_inputs(inputs, group, group.uses)  # [N, S, d_in]
            P = sqrt_corr * (g.transpose(-1, -2) @ a)  # [V, N, d_out, d_in]
            by_shape.setdefault(tuple(P.shape), []).append((gi, P))
        del grads, inputs
        for members in by_shape.values():
            S_1, S_2, info = batched_top_rank_one_kron_factors(
                torch.stack([P for _, P in members]), self.power_iters, self.power_tol,
                self._shards.all_reduce,
            )
            for i, (gi, _) in enumerate(members):
                first[gi], second[gi] = S_1[i], S_2[i]
                infos[gi] = {name: v[i] for name, v in info.items()}
        self.power_info = dict(sorted(infos.items()))
        return second, first, self.groups


class KFOCLinearOperator(KFACLinearOperator):
    """Frobenius-optimal rank-one Kronecker proxy of the GGN.

    Warning:
        Factors are not symmetrized or PSD-projected; verify before using
        them with routines that assume PSD factors.
    """

    def __init__(
        self,
        model: torch.nn.Module,
        loss_fn,
        params: Any,
        data,
        *,
        fisher_type: str = FisherType.MC,
        mc_samples: int = 1,
        separate_weight_and_bias: bool = True,
        num_data: int | None = None,
        num_per_example_loss_terms: int | None = None,
        seed: int = 2147483647,
        batch_size_fn=None,
        check_deterministic: bool = True,
        power_iters: int = 2000,
        power_tol: float | None = None,
        mesh=None,
        data_axis: str = "data",
    ):
        computer = KFOCComputer(
            model, loss_fn, params, data,
            fisher_type=fisher_type,
            mc_samples=mc_samples,
            separate_weight_and_bias=separate_weight_and_bias,
            num_data=num_data,
            num_per_example_loss_terms=num_per_example_loss_terms,
            seed=seed,
            batch_size_fn=batch_size_fn,
            check_deterministic=check_deterministic,
            power_iters=power_iters,
            power_tol=power_tol,
            mesh=mesh,
            data_axis=data_axis,
        )
        aaT, ggT, groups = computer.compute_kfoc()
        self._build_from_factors(computer.params, groups, aaT, ggT)
        self._computer = computer
        #: per weight group: {"iterations", "residual", "sigma"}
        self.power_info = computer.power_info
