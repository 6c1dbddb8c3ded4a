"""Exact (type-2) and Monte-Carlo GGN diagonal.

PyTorch counterpart of ``curvlinops_tpu/curvature/ggn_diagonal.py``. Per
datum, the GGN diagonal's contribution is ``sum_v (J_n^T g_nv)^2`` with the
grad-output vectors ``g_nv`` (the loss Hessian's square-root columns when
``mc_samples == 0``, sampled vectors otherwise). The per-datum ``vjp`` is
mapped with ``torch.func.vmap`` over the grad-output vectors and over the
samples, and the result is materialised as a
:class:`~curvlinops_tpu_torch.ops.diagonal.DiagonalLinearOperator`: after
the one-time build, a matvec is an elementwise product with no data pass.

Differences from the JAX package:

- The grad-output vectors of a batch are drawn at once, from the batched
  prediction and the per-batch generator of the MC Fisher operator
  (:func:`~curvlinops_tpu_torch.risk.batch_generator`). The JAX package
  draws them per datum from split keys.
- A prediction may hold ``R`` rows per datum (the GPT's ``[B * T, vocab]``,
  ``R = T``), which the JAX diagonal cannot take. With ``R == 1`` (``[N, C]``
  or ``[N, C, *S]`` predictions) the MC diagonal is the diagonal of
  ``GGNLinearOperator(..., mc_samples=k)`` with the same samples. With
  ``R > 1`` it is not: that operator gives each row its own sample, so its
  diagonal is ``sum_r (J_r^T g_r)^2``, which would take ``R`` vjps per
  datum and sample. The MC diagonal takes one, ``(sum_r J_r^T g_r)^2``, on
  the same samples: an unbiased estimate of the same GGN diagonal (the
  rows' samples are independent with mean zero), with the rows' cross terms
  as extra variance. The JAX package's per-datum sampling gives the same
  per-datum form.
- The samples are mapped in chunks: the per-datum gradients are
  ``[chunk, V, P]``, which for ResNet-18's exact diagonal (``V = 10``,
  ``P = 11,181,642``) is 447 MB a datum in float32. A chunk holds at most
  :data:`_CHUNK_BYTES` of them.
- The vmap-compatibility probe compares by norm
  (:func:`~curvlinops_tpu_torch.ops.base.close_by_norm`), as the port's
  determinism rails do.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
from torch.utils import _pytree as pytree

from curvlinops_tpu_torch.curvature.loss_hessian import (
    FisherType,
    make_grad_output_fn,
    mean_rescale,
)
from curvlinops_tpu_torch.ops.base import close_by_norm
from curvlinops_tpu_torch.ops.diagonal import DiagonalLinearOperator
from curvlinops_tpu_torch.risk import default_batch_size
from curvlinops_tpu_torch.utils.flatten import tree_add
from curvlinops_tpu_torch.utils.misc import as_model_fn

_CHUNK_BYTES = 2**32  # per-datum gradients [chunk, V, P] mapped at once


def _slice(X: Any, start: int, stop: int) -> Any:
    return pytree.tree_map(lambda leaf: leaf[start:stop], X)


def _datum_vectors(G: torch.Tensor, N: int, exact: bool) -> torch.Tensor:
    """Per-datum grad-output vectors ``[N, V', R, *row]`` from the batch's
    ``[N * R, V, *row]`` (``R`` prediction rows per datum: 1 for a
    classifier, the sequence length for the GPT, whose prediction is
    ``[B * T, vocab]``).

    Exact: each square-root column stays on its own row (``V' = R * V``),
    so ``sum_v (J_n^T g_nv)^2`` is each row's diagonal. MC: each of the ``V``
    samples covers all rows of the datum at once (``V' = V``), as the JAX
    package's per-datum sampling does; the rows' samples are independent
    with mean zero, so the cross terms vanish in expectation (see the
    module docstring).
    """
    rows, V = G.shape[:2]
    R = rows // N
    G = G.reshape(N, R, V, *G.shape[2:])
    if not exact or R == 1:
        return G.movedim(2, 1)
    one_row = G.new_zeros((N, R, V, R, *G.shape[3:]))
    idx = torch.arange(R, device=G.device)
    one_row[:, idx, :, idx] = G.movedim(1, 0)
    return one_row.reshape(N, R * V, R, *G.shape[3:])


def make_batch_ggn_diagonal(model_fn: Callable, loss_fn, mc_samples: int = 0) -> Callable:
    """Build the per-batch GGN-diagonal kernel ``(params, X, y, c, generator) -> diag``."""
    fisher_type = FisherType.MC if mc_samples > 0 else FisherType.TYPE2
    grad_output_fn = make_grad_output_fn(loss_fn, fisher_type, max(mc_samples, 1))

    def per_datum(params, x_n, g_n):
        def f_n(p):
            return model_fn(p, pytree.tree_map(lambda leaf: leaf[None], x_n))

        _, vjp_fn = torch.func.vjp(f_n, params)
        JTg = torch.func.vmap(lambda g: vjp_fn(g)[0])(g_n)  # leaves [V', *p]
        return pytree.tree_map(lambda t: (t**2).sum(0), JTg)

    def batch_diag(params: Any, X: Any, y: torch.Tensor, c: float, generator) -> Any:
        with torch.no_grad():
            pred = model_fn(params, X)
        N = default_batch_size(X)
        G = _datum_vectors(grad_output_fn(pred, y, generator), N, mc_samples == 0)
        leaves = pytree.tree_leaves(params)
        per_datum_bytes = G.shape[1] * sum(t.numel() for t in leaves) * leaves[0].element_size()
        chunk = max(1, _CHUNK_BYTES // per_datum_bytes)
        diag = None
        for start in range(0, N, chunk):
            contribs = torch.func.vmap(per_datum, in_dims=(None, 0, 0))(
                params, _slice(X, start, start + chunk), G[start:start + chunk]
            )
            part = pytree.tree_map(lambda t: t.sum(0), contribs)
            diag = part if diag is None else tree_add(diag, part)
        # the mean over the prediction's rows, as the MC Fisher operator's;
        # mean_rescale turns the static loss-term count into the CE
        # ignore_index denominator (1 unpadded)
        c_batch = float(pred.shape[0]) if loss_fn.reduction == "mean" else 1.0
        c_batch = c_batch / mean_rescale(loss_fn, y)
        return pytree.tree_map(lambda t: t * c / c_batch, diag)

    return batch_diag


class GGNDiagonalLinearOperator(DiagonalLinearOperator):
    """The diagonal of the GGN, materialised once and applied elementwise.

    The dataset plumbing (the determinism probes, ``num_data``, the
    normalisation factors, the per-batch generators) is an internal
    :class:`~curvlinops_tpu_torch.curvature.ggn.GGNLinearOperator`'s, so the
    conventions cannot drift from the risk layer's. The vmap-compatibility
    probe (the batched forward against the mapped per-datum forward) is the
    diagonal's own, and runs first.

    Args:
        mc_samples: ``0`` (default) for the exact diagonal; ``> 0`` for the
            Monte-Carlo diagonal from that many sampled grad-output vectors
            per datum (one vjp per datum and sample, over all of the
            datum's prediction rows).

    Other arguments as :class:`curvlinops_tpu_torch.risk.EmpiricalRiskOperator`.
    """

    def __init__(
        self,
        model,
        loss_fn,
        params: Any,
        data,
        *,
        mc_samples: int = 0,
        seed: int = 2147483647,
        batch_size_fn: Callable | None = None,
        num_data: int | None = None,
        check_deterministic: bool = True,
        mesh=None,
        data_axis: str = "data",
        progressbar: bool = False,
    ):
        from curvlinops_tpu_torch.curvature.ggn import GGNLinearOperator

        if check_deterministic:
            # before the helper's probes: a transform over a BatchNorm in
            # training mode fails on its running-statistics update
            self._check_vmap_compatible(
                as_model_fn(model), pytree.tree_map(lambda t: t.detach(), params), data
            )
        helper = GGNLinearOperator(
            model, loss_fn, params, data,
            mc_samples=mc_samples, seed=seed, batch_size_fn=batch_size_fn,
            num_data=num_data, check_deterministic=check_deterministic,
            mesh=mesh, data_axis=data_axis, progressbar=progressbar,
        )

        batch_diag = make_batch_ggn_diagonal(helper._model_fn, loss_fn, mc_samples)
        diag = None
        with torch.no_grad():
            # the helper's per-batch generators (seed, MC iff mc_samples > 0)
            for X, y, c, gen in helper._shard_loop(desc="ggn_diagonal"):
                out = batch_diag(helper._params, X, y, c, gen)
                diag = out if diag is None else tree_add(diag, out)
        if diag is None:
            raise ValueError("Empty dataset.")
        super().__init__(helper._shards.all_reduce(diag))

        self._model_fn, self._loss_fn, self._params = helper._model_fn, loss_fn, helper._params
        self._data, self._mc_samples = data, mc_samples

        if check_deterministic:
            self.check_deterministic_matvec()

    @staticmethod
    def _check_vmap_compatible(model_fn: Callable, params: Any, data) -> None:
        """``f(X) == vmap(per-datum f)(X)`` on the first batch, by norm.

        Raises:
            RuntimeError: If the model treats batched and per-example inputs
                differently (e.g. BatchNorm in training mode).
        """
        X0, _ = next(iter(data))

        def single(x_n):
            return model_fn(params, pytree.tree_map(lambda leaf: leaf[None], x_n))

        message = (
            "Model is not vmap-compatible: batched forward differs from "
            "vmapped per-example forward (BatchNorm in training mode?)."
        )
        with torch.no_grad():
            batched = model_fn(params, X0)
            try:
                mapped = torch.func.vmap(single)(X0)
            except (RuntimeError, ValueError) as err:
                raise RuntimeError(message) from err
            mapped = mapped.reshape(batched.shape)  # [N, R, *row] -> [N * R, *row]
        if not close_by_norm(mapped, batched, rtol=5e-5, atol=1e-6):
            raise RuntimeError(message)

