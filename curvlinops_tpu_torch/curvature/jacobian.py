"""Jacobian and transposed-Jacobian linear operators.

PyTorch counterpart of ``curvlinops_tpu/curvature/jacobian.py``. ``J`` maps
parameter space to the stacked prediction space ``[N, *out]``: per batch, a
``torch.func.jvp`` mapped over the columns gives the batch's block of rows,
and the blocks are concatenated. ``J^T`` slices its input rows per batch
and adds the pullbacks of one ``torch.func.vjp`` per batch. Both need a
fixed data order, and each is the other's adjoint. Where the operator holds
its batches on the device (``fuse_batches``, as the curvature operators
do), both read them from there, so a product touches no loader and a
solve over them (LSMR) can be captured. Under a mesh, ``J``
gathers each batch's rows from the processes that computed them, and
``J^T`` pulls back this process's rows of each batch and sums over the
mesh's data axis.
"""

from __future__ import annotations

from typing import Any

import torch

from curvlinops_tpu_torch.risk import EmpiricalRiskOperator, _held_batches, default_batch_size
from curvlinops_tpu_torch.utils.flatten import TensorSpec, spec_of, tree_add, vmap_columns
from curvlinops_tpu_torch.utils.misc import as_model_fn


def _num_data(data, kw: dict) -> int:
    """``kw["num_data"]``, or the summed batch sizes (one traversal)."""
    num_data = kw.pop("num_data", None)
    if num_data is None:
        bs_fn = kw.get("batch_size_fn") or default_batch_size
        num_data = sum(bs_fn(X) for X, _ in data)
    return num_data


def _batches(op: EmpiricalRiskOperator, desc: str):
    """``(X, y, c, generator or tape)`` of this process's batches: the held
    ones of the fused state where the operator has one, else streamed."""
    state = op._fused_state()
    return _held_batches(state) if state is not None else op._shard_loop(desc=desc)


def _prediction_spec(model, params, data, num_data: int) -> TensorSpec:
    """Spec of the stacked predictions ``[num_data, *out]``, from one
    forward pass on the first batch."""
    X0, _ = next(iter(data))
    with torch.no_grad():
        out = as_model_fn(model)(params, X0)
    return TensorSpec((num_data,) + tuple(out.shape[1:]), out.dtype, out.device)


class JacobianLinearOperator(EmpiricalRiskOperator):
    """Matrix-free Jacobian ``J: params -> [N, *out]`` of the model predictions."""

    FIXED_DATA_ORDER = True

    def __init__(self, model, params, data, **kw):
        num_data = _num_data(data, kw)
        out_spec = _prediction_spec(model, params, data, num_data)
        super().__init__(model, None, params, data, num_data=num_data, out_spec=out_spec, **kw)

    @torch.no_grad()  # as EmpiricalRiskOperator._matmat: no graph to the module's own parameters
    def _matmat(self, M: Any) -> Any:
        model_fn, params = self._model_fn, self._params
        blocks = []
        for X, _, _, _ in _batches(self, "jacobian"):

            def jvp_one(v, X=X):
                return torch.func.jvp(lambda p: model_fn(p, X), (params,), (v,))[1]

            block = vmap_columns(jvp_one, M, self._max_vmap_columns)
            blocks.append(self._shards.gather_rows(block))
        return torch.cat(blocks, dim=0)

    def _adjoint(self) -> "TransposedJacobianLinearOperator":
        return TransposedJacobianLinearOperator(
            self._model_fn,
            self._params,
            self._data,
            num_data=self._N_data,
            batch_size_fn=self._batch_size_fn,
            check_deterministic=False,
            mesh=self._mesh,
            data_axis=self._data_axis,
        )


class TransposedJacobianLinearOperator(EmpiricalRiskOperator):
    """Matrix-free transposed Jacobian ``J^T: [N, *out] -> params``."""

    FIXED_DATA_ORDER = True

    def __init__(self, model, params, data, **kw):
        num_data = _num_data(data, kw)
        in_spec = _prediction_spec(model, params, data, num_data)
        super().__init__(
            model, None, params, data,
            num_data=num_data, in_spec=in_spec, out_spec=spec_of(params), **kw,
        )

    @torch.no_grad()  # as EmpiricalRiskOperator._matmat
    def _matmat(self, M: Any) -> Any:
        index, count = self._shards.index, self._shards.count
        out, offset = None, 0
        for X, _, _, _ in _batches(self, "jacobian_t"):
            B = self._batch_size_fn(X)  # this process's rows of the batch
            _, vjp_fn = torch.func.vjp(lambda p: self._model_fn(p, X), self._params)
            start = offset + index * B
            res = vmap_columns(lambda w: vjp_fn(w)[0], M[start:start + B], self._max_vmap_columns)
            out = res if out is None else tree_add(out, res)
            offset += B * count
        return self._shards.all_reduce(out)

    def _adjoint(self) -> JacobianLinearOperator:
        return JacobianLinearOperator(
            self._model_fn,
            self._params,
            self._data,
            num_data=self._N_data,
            batch_size_fn=self._batch_size_fn,
            check_deterministic=False,
            mesh=self._mesh,
            data_axis=self._data_axis,
        )
