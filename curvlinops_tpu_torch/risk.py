"""Empirical-risk machinery shared by all curvature operators.

PyTorch counterpart of ``curvlinops_tpu/risk.py``. An operator is built from
a model (an ``nn.Module`` applied with ``torch.func.functional_call`` to a
dict of named parameters, or a plain callable ``(params, X) ->
prediction``), a loss, the parameters at which the curvature is evaluated,
and an iterable of ``(X, y)`` batches. The per-batch matrix-matrix product
is one function ``(params, X, y, M, c, generator) -> c * A_batch M`` built
with ``torch.func`` transforms.

The loop over the dataset is fused as in the JAX package
(``fuse_batches``, class default ``"auto"``): the batches are read once and
held on the device (:meth:`EmpiricalRiskOperator._materialize_fused_state`),
and the whole accumulation, every batch's kernel and every add, runs as one
:class:`~curvlinops_tpu_torch.utils.graphs.CapturedProgram` per number of
columns and dtype: a CUDA graph replayed with one launch (eagerly on the
CPU). The mode record ``_batch_fn_cache["fused_state"][0]`` is JAX's:
``"scan"`` for uniform batches of at most ``_FUSE_STACK_BYTE_LIMIT`` bytes in
all, ``"unroll"`` for at most ``_FUSE_UNROLL_LIMIT`` other batches. The
batches stream one at a time (``fused_state`` is ``None``) past those limits
(a graph per batch shape would keep a memory pool each; reading stops at the
first batch past both, so at most ``_FUSE_UNROLL_LIMIT`` batches are ever
held for a dataset that streams), with a progress
bar, or with ``fuse_batches = False``, the opt-out. On the card a capture
that fails raises; nothing falls back to streaming.

Differences from the JAX package:

- A dataset of one batch is fused too (mode ``"single"``), where the JAX
  package streams it through its jitted per-batch program: one captured
  program is that program's counterpart.
- Randomness comes from one ``torch.Generator`` per batch,
  :func:`batch_generator` of the operator's seed and the batch index, in
  the order the data is read (the JAX package's ``fold_in``): chained or
  repeated matvecs replay the same samples. The fused loop samples each
  batch once, from that generator, and replays the outcome
  (:class:`~curvlinops_tpu_torch.utils.graphs.DrawTape`): the streamed
  samples, held on the device (a cross-entropy batch holds its sampled
  class indices, ``[N, D, M]`` integers, not the ``[N, D, M, C]`` race).
- The determinism rails compare gradients and matvecs by norm
  (:func:`~curvlinops_tpu_torch.ops.base.close_by_norm`): cuDNN's
  weight-gradient atomics make two identical passes differ entrywise.
- Cross-entropy targets are checked on the host before any loss is
  computed: on a GPU an out-of-range class index is a device-side assert
  that ends the CUDA context.
- :meth:`EmpiricalRiskOperator.linearized` holds each batch's model
  linearization as a traced graph whose primal values are evaluated once
  (:mod:`curvlinops_tpu_torch.curvature.held`), where the JAX package holds
  ``jax.linearize``'s residuals.
- With ``mesh=`` every process builds the operator from the same full
  batches and computes on its slice of each batch
  (:class:`~curvlinops_tpu_torch.parallel.mesh.DataShards`), where GSPMD
  partitions the JAX package's programs. The dataset statistics and each
  batch's normalisation read the whole batch, the MC draws are the whole
  batch's (:class:`~curvlinops_tpu_torch.parallel.mesh.ShardedGenerator`),
  each product is summed over the mesh's data axis once, after the batch
  loop, and the determinism probes decide on reduced values, so that every
  process takes the same branch. A fused program holds the process's loop;
  the sum over the mesh runs after its replay, outside the graph, so a
  Neumann series or Lanczos recurrence over a mesh operator runs eagerly
  (:attr:`EmpiricalRiskOperator.capturable`), replaying the fused loop
  once a product.
"""

from __future__ import annotations

import math
from collections.abc import Iterable
from typing import Any, Callable

import numpy as np
import torch
from torch import nn
from torch.utils import _pytree as pytree

from curvlinops_tpu_torch.losses import CrossEntropyLoss, Loss
from curvlinops_tpu_torch.ops.base import (
    LinearOperator,
    cached_program,
    close_by_norm,
    program_pool,
)
from curvlinops_tpu_torch.parallel.mesh import DataShards, gather_params
from curvlinops_tpu_torch.utils.flatten import spec_of, tree_add
from curvlinops_tpu_torch.utils.graphs import CapturedProgram, DrawTape
from curvlinops_tpu_torch.utils.misc import as_model_fn


def default_batch_size(X: Any) -> int:
    """Leading dimension of ``X`` (a tensor, or the first tensor of a dict/sequence)."""
    if isinstance(X, torch.Tensor):
        return int(X.shape[0])
    leaves = list(X.values()) if isinstance(X, dict) else list(X)
    if not leaves:
        raise ValueError("Cannot infer batch size from an empty input.")
    return default_batch_size(leaves[0])


def _num_loss_terms_in_batch(loss_func: Loss, y: torch.Tensor) -> int:
    """Count the loss terms in a batch target (one per CE target entry,
    one per row of an MSE/BCE target)."""
    shape = tuple(y.shape)
    if isinstance(loss_func, CrossEntropyLoss):
        return math.prod(shape) if shape else 1
    return math.prod(shape[:-1]) if len(shape) > 1 else shape[0]


def batch_generator(seed: int, batch_index: int, device: torch.device) -> torch.Generator:
    """Generator for one batch: ``seed`` folded with the batch index, so every
    pass over the data draws the same samples for every batch."""
    state = np.random.SeedSequence([seed, batch_index]).generate_state(1, np.uint64)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(state[0]))
    return gen


def _accumulate_matmat(kernel: Callable, params: Any, M: Any, batches: Iterable) -> Any:
    """``sum_b kernel(params, X_b, y_b, M, c_b, gen_b)`` over ``batches`` of
    ``(X, y, c, generator)``, in order: the one accumulation of the streamed
    and the fused loop.

    Raises:
        ValueError: If there are no batches.
    """
    AM = None
    for X, y, c, gen in batches:
        out = kernel(params, X, y, M, c, gen)
        AM = out if AM is None else tree_add(AM, out)
    if AM is None:
        raise ValueError("Empty dataset: no batches to accumulate over.")
    return AM


def _accumulate_gradient_and_loss(
    model_fn: Callable, loss_fn, params: Any, batches: Iterable
) -> tuple[Any, torch.Tensor]:
    """``(gradient, loss)`` of ``sum_b c_b * loss_b`` over ``batches`` of
    ``(X, y, c, generator)``: the one accumulation of the streamed and the
    fused loop."""
    total_grad, total_loss = None, None
    for X, y, c, _ in batches:
        grad, loss = torch.func.grad_and_value(lambda p: c * loss_fn(model_fn(p, X), y))(params)
        total_loss = loss if total_loss is None else total_loss + loss
        total_grad = grad if total_grad is None else tree_add(total_grad, grad)
    return total_grad, total_loss


def _held_batches(state: tuple):
    """Yield ``(X, y, c, tape)`` over the held batches of a fused state, each
    tape rewound to its first draw."""
    _, data, cs, tapes = state
    for (X, y), c, tape in zip(data, cs, tapes):
        if tape is not None:
            tape.rewind()
        yield X, y, c, tape


def _tree_close(a: Any, b: Any, rtol: float, atol: float) -> bool:
    la, lb = pytree.tree_leaves(a), pytree.tree_leaves(b)
    return len(la) == len(lb) and all(close_by_norm(x, y, rtol, atol) for x, y in zip(la, lb))


class EmpiricalRiskOperator(LinearOperator):
    """Base for operators defined by autodiff over an empirical-risk dataset.

    Args:
        model: An ``nn.Module`` (applied with ``functional_call`` to
            ``params``; its other parameters and buffers stay fixed) or a
            callable ``(params, X) -> prediction``.
        loss_fn: A :class:`curvlinops_tpu_torch.losses.Loss` (or any callable
            ``(prediction, y) -> scalar`` with a ``reduction`` attribute), or
            ``None`` for loss-independent operators (Jacobians).
        params: The parameters at which the matrix is evaluated: a dict of
            named tensors (any tree for a callable ``model``).
        data: Iterable of ``(X, y)`` mini-batches; ``X`` may be a dict
            (with ``batch_size_fn``).
        batch_size_fn: Batch size from ``X``; defaults to the first tensor's
            leading dim.
        num_data: Dataset size; inferred with one traversal if ``None``.
        num_per_example_loss_terms: Loss terms per example (e.g. tokens per
            sequence); inferred when required and ``None``.
        check_deterministic: Run the two-pass loss/gradient and the
            double-matvec determinism probes at construction.
        seed: Base seed of operators that sample (MC Fisher); each batch's
            generator is :func:`batch_generator` of it and the batch index.
        mesh: Optional ``DeviceMesh`` (:func:`~curvlinops_tpu_torch.parallel.make_mesh`)
            for data-parallel execution: every process passes the same
            arguments, computes on its slice of each batch and gets the
            replicated result. ``DTensor`` parameters are gathered whole.
        data_axis: Mesh axis name to split the batches over.
        progressbar: Show a tqdm progress bar over batches.
        max_vmap_columns: Bound on the columns of a matmat mapped at once.

    Raises:
        ValueError: If ``model`` is not callable, ``loss_fn`` has no
            ``'mean'``/``'sum'`` reduction, or ``mesh`` has no ``data_axis``;
            under a mesh, from a product, if a batch does not divide over
            the data axis.
    """

    SELF_ADJOINT: bool = False
    FIXED_DATA_ORDER: bool = False
    NEEDS_NUM_PER_EXAMPLE_LOSS_TERMS: bool = False
    USES_RANDOMNESS: bool = False

    # "auto" fuses the dataset loop within the limits below; False streams
    fuse_batches: bool | str = "auto"
    # uniform batches of at most this many bytes in all fuse as "scan" at any
    # batch count (the JAX package stacks them into one array)
    _FUSE_STACK_BYTE_LIMIT = 2 << 30
    # at most this many other batches fuse as "unroll"; more stream
    _FUSE_UNROLL_LIMIT = 64

    def __init__(
        self,
        model: nn.Module | Callable[[Any, Any], torch.Tensor],
        loss_fn: Loss | None,
        params: Any,
        data: Iterable[tuple[Any, Any]],
        *,
        batch_size_fn: Callable[[Any], int] | None = None,
        num_data: int | None = None,
        num_per_example_loss_terms: int | None = None,
        check_deterministic: bool = True,
        seed: int = 2147483647,
        mesh=None,
        data_axis: str = "data",
        progressbar: bool = False,
        max_vmap_columns: int | None = None,
        in_spec: Any = None,
        out_spec: Any = None,
    ):
        if loss_fn is not None and getattr(loss_fn, "reduction", None) not in ("mean", "sum"):
            raise ValueError(
                "loss_fn must expose a `reduction` attribute equal to 'mean' "
                f"or 'sum' (got {getattr(loss_fn, 'reduction', None)!r}); "
                "use the losses in curvlinops_tpu_torch.losses."
            )
        self._mesh, self._data_axis = mesh, data_axis
        self._shards = DataShards(mesh, data_axis)
        if mesh is not None:
            params = gather_params(params)
        self._model_fn = as_model_fn(model)
        self._loss_fn = loss_fn
        self._params = pytree.tree_map(lambda t: t.detach(), params)
        self._data = data
        self._batch_size_fn = batch_size_fn or default_batch_size
        self._seed = seed
        self._progressbar = progressbar
        self._max_vmap_columns = max_vmap_columns
        self._batch_matmat_fn: Callable | None = None
        self._batch_fn_cache: dict[str, Any] = {}

        param_spec = spec_of(self._params)
        super().__init__(
            param_spec if in_spec is None else in_spec,
            param_spec if out_spec is None else out_spec,
        )
        self._N_data, self._num_per_example_loss_terms = self._get_data_statistics(
            num_data, num_per_example_loss_terms
        )
        if check_deterministic:
            self._check_deterministic()
            self.check_deterministic_matvec()

    # ---- data statistics and iteration ---------------------------------- #
    @property
    def num_data(self) -> int:
        """Number of data points in the dataset."""
        return self._N_data

    @property
    def num_per_example_loss_terms(self) -> int | None:
        """Loss terms per example, when tracked."""
        return self._num_per_example_loss_terms

    def _get_data_statistics(
        self, num_data: int | None, num_per_example_loss_terms: int | None
    ) -> tuple[int, int | None]:
        """Infer the dataset size and loss terms per example in at most one
        traversal (shapes only).

        Raises:
            ValueError: If the loss terms are not divisible by the data count.
        """
        need_n = num_data is None
        need_terms = (
            self.NEEDS_NUM_PER_EXAMPLE_LOSS_TERMS
            and self._loss_fn is not None
            and num_per_example_loss_terms is None
        )
        if not need_n and not need_terms:
            return num_data, num_per_example_loss_terms
        n_acc, terms_acc = 0, 0
        for X, y in self._data:
            if need_n:
                n_acc += self._batch_size_fn(X)
            if need_terms:
                terms_acc += _num_loss_terms_in_batch(self._loss_fn, y)
        n = n_acc if need_n else num_data
        if need_terms:
            if terms_acc % n != 0:
                raise ValueError(
                    "The number of loss terms must be divisible by the number of "
                    f"data points; num_loss_terms={terms_acc}, N_data={n}."
                )
            num_per_example_loss_terms = terms_acc // n
        return n, num_per_example_loss_terms

    def _loop_over_data(self, desc: str | None = None):
        """Yield the mini-batches (through tqdm when ``progressbar``)."""
        data_iter = self._data
        if self._progressbar:
            try:
                from tqdm import tqdm

                data_iter = tqdm(data_iter, desc=f"{type(self).__name__}.{desc or 'batches'}")
            except ImportError:
                pass
        yield from data_iter

    def _get_normalization_factor(self, X: Any, y: Any) -> float:
        """Batch-to-dataset normalization: ``B / N`` for mean, 1 for sum."""
        if self._loss_fn is None:
            return 1.0
        return {"sum": 1.0, "mean": self._batch_size_fn(X) / self._N_data}[
            self._loss_fn.reduction
        ]

    def _slice_factor(self, X: Any, y: Any, ys: Any) -> Any:
        """The normalization factor of this process's slice (targets ``ys``)
        of a batch ``(X, y)``: :meth:`_get_normalization_factor` of the
        whole batch, which is the factor without a mesh.

        A mean-reduced loss on a slice averages over the slice's loss terms,
        so the whole batch's factor is scaled by the slice's share of the
        batch's terms: its share of the rows, or for cross-entropy its share
        of the targets that are not ``ignore_index`` (the mean's
        denominator, which differs between slices).
        """
        c = self._get_normalization_factor(X, y)
        if self._mesh is None or self._loss_fn is None or self._loss_fn.reduction == "sum":
            return c
        if isinstance(self._loss_fn, CrossEntropyLoss):
            ignore = self._loss_fn.ignore_index
            share = (ys != ignore).sum() / (y != ignore).sum().clamp(min=1).to(ys.device)
            return c * share.to(self.dtype)
        return c / self._shards.count

    def _shard_loop(self, desc: str | None = None):
        """Yield ``(X, y, c, generator)`` per batch: this process's slice of
        the batch (the whole batch without a mesh), its normalization factor
        (:meth:`_slice_factor`) and, for operators that sample, the batch's
        generator (seen through the slice under a mesh).

        Raises:
            ValueError: If a leading dimension does not divide over the
                mesh's data axis.
        """
        make = None
        if self.USES_RANDOMNESS:
            make = lambda idx: batch_generator(self._seed, idx, self.device)  # noqa: E731
        for X, y, Xs, ys, gen in self._shards.batches(
            self._loop_over_data(desc=desc), self.device, make
        ):
            yield Xs, ys, self._slice_factor(X, y, ys), gen

    def linearized(self, remat=None) -> LinearOperator:
        """Hold the per-batch model linearizations on the device.

        Returns an operator computing the same matrix (the MC Fisher with the
        same samples) whose products run no primal forward (and, for the
        Hessian, no primal backward): the primal values the tangents need
        are evaluated once, here. The trade for iterative work against fixed
        data, at the memory cost of each batch's residuals. See
        :class:`curvlinops_tpu_torch.curvature.held.HeldLinearizationOperator`.

        Args:
            remat: ``None`` (default) holds every residual; ``True`` holds
                only the parameters and the data and recomputes the rest
                inside each product; a selective-checkpoint policy
                (:func:`curvlinops_tpu_torch.curvature.held.save_smaller_than`)
                chooses which values to hold.
        """
        from curvlinops_tpu_torch.curvature.held import HeldLinearizationOperator

        return HeldLinearizationOperator(self, remat=remat)

    # ---- the hot path: accumulated per-batch matmat --------------------- #
    def _make_batch_matmat(self) -> Callable:
        """The per-batch kernel ``(params, X, y, M, c, generator) -> c * A_b M``;
        ``M`` carries a trailing column axis on every leaf."""
        raise NotImplementedError

    @property
    def capturable(self) -> bool:
        """Whether a program (a solve, a Neumann series, a Lanczos
        recurrence) may capture the products inline: the batches are fused
        (held on the device, their draws taped) and no sum over a mesh
        follows. A streamed operator reads its loader (host copies, a
        prefetch thread, fresh generators) and a mesh's ``all_reduce`` or
        ``all_gather`` runs after each product, so a program over either
        runs eagerly."""
        return self._mesh is None and self._fused_state() is not None

    def _fused_state(self) -> tuple | None:
        """The held batches of the fused loop, or ``None`` to stream."""
        if self._progressbar or self.fuse_batches is False:
            return None
        if "fused_state" not in self._batch_fn_cache:
            self._materialize_fused_state()
        return self._batch_fn_cache["fused_state"]

    def _materialize_fused_state(self) -> None:
        """Read the dataset once and record ``_batch_fn_cache["fused_state"]``.

        It is ``(mode, data, cs, tapes)``: this process's slice of each batch
        (on the device, as the streamed loop reads it), its normalization
        factor (:meth:`_slice_factor`) and, for operators that sample, a
        :class:`DrawTape` of its generator; or ``None`` past the limits (the
        JAX package's policy, except that one batch is ``"single"``). Reading
        stops, and what was held is dropped, at the first batch that puts the
        dataset past both limits: more than ``_FUSE_UNROLL_LIMIT`` batches
        that are ragged or exceed ``_FUSE_STACK_BYTE_LIMIT`` bytes in all.
        """
        make = None
        if self.USES_RANDOMNESS:
            make = lambda idx: batch_generator(self._seed, idx, self.device)  # noqa: E731
        data, cs, tapes, signatures, nbytes = [], [], [], set(), 0
        batches = self._shards.batches(self._loop_over_data(desc="fuse_batches"), self.device, make)
        for X, y, Xs, ys, gen in batches:
            leaves, spec = pytree.tree_flatten((X, y))
            signatures.add((spec, tuple(tuple(t.shape) for t in leaves)))
            nbytes += sum(t.numel() * t.element_size() for t in leaves)
            uniform = len(signatures) == 1 and nbytes <= self._FUSE_STACK_BYTE_LIMIT
            if len(data) >= self._FUSE_UNROLL_LIMIT and not uniform:
                batches.close()  # past both limits: stream, holding nothing
                self._batch_fn_cache["fused_state"] = None
                return
            data.append((Xs, ys))
            cs.append(self._slice_factor(X, y, ys))
            tapes.append(None if gen is None else DrawTape(gen))
        if len(data) == 1:
            mode = "single"
        elif len(signatures) == 1 and nbytes <= self._FUSE_STACK_BYTE_LIMIT:
            mode = "scan"
        elif 1 < len(data) <= self._FUSE_UNROLL_LIMIT:
            mode = "unroll"
        else:
            mode = None
        self._batch_fn_cache["fused_state"] = mode and (mode, data, cs, tapes)

    @torch.no_grad()
    def _matmat(self, M: Any) -> Any:
        # no_grad: the torch.func transforms inside ignore it, and it keeps
        # autograd from recording the products against the module's own
        # parameters that ``params`` leaves out (a partial dict), a graph
        # that an iterative solver's loop would keep alive
        if self._batch_matmat_fn is None:
            self._batch_matmat_fn = self._make_batch_matmat()
        kernel, params = self._batch_matmat_fn, self._params
        state = self._fused_state()
        if state is None:
            return self._shards.all_reduce(
                _accumulate_matmat(kernel, params, M, self._shard_loop(desc="matmat"))
            )
        leaf = pytree.tree_leaves(M)[0]
        program = cached_program(
            self, ("fused_matmat", leaf.shape[-1], leaf.dtype),
            lambda: CapturedProgram(
                lambda M: _accumulate_matmat(kernel, params, M, _held_batches(state)),
                self.device, f"{type(self).__name__}'s fused matmat",
                program_pool(self, self.device),
            ),
        )
        return self._shards.all_reduce(program(M))

    # ---- gradient and loss over the dataset ----------------------------- #
    @torch.no_grad()
    def gradient_and_loss(self) -> tuple[Any, torch.Tensor]:
        """The full-dataset gradient and loss, ``(gradient tree, scalar loss)``.

        Raises:
            ValueError: If no loss function was specified.
        """
        if self._loss_fn is None:
            raise ValueError("No loss function specified.")
        model_fn, loss_fn, params = self._model_fn, self._loss_fn, self._params
        state = self._fused_state()
        if state is None:
            return self._shards.all_reduce(_accumulate_gradient_and_loss(
                model_fn, loss_fn, params, self._shard_loop(desc="gradient_and_loss")
            ))
        program = cached_program(
            self, ("fused_grad_loss",),
            lambda: CapturedProgram(
                lambda: _accumulate_gradient_and_loss(
                    model_fn, loss_fn, params, _held_batches(state)),
                self.device, f"{type(self).__name__}'s fused gradient_and_loss",
                program_pool(self, self.device),
            ),
        )
        return self._shards.all_reduce(program())

    # ---- determinism rails ---------------------------------------------- #
    def _batch_pred_loss_grad(self):
        """Yield ``((X, y), prediction, loss, grad)`` per batch.

        The targets are checked (:meth:`_validate_targets`) after the forward
        pass, which gives the class count, and before the loss.
        """
        model_fn, loss_fn = self._model_fn, self._loss_fn
        batches = self._loop_over_data(desc="check_deterministic")
        for X_full, y_full, X, y, _ in self._shards.batches(batches, self.device):
            c = self._slice_factor(X_full, y_full, y)
            if loss_fn is None:
                with torch.no_grad():
                    pred = model_fn(self._params, X)
                yield (X, y), pred, None, None
                continue
            pred, vjp_fn = torch.func.vjp(lambda p: model_fn(p, X), self._params)
            self._validate_targets(pred, y_full)  # the whole batch: every process alike
            grad_pred, loss = torch.func.grad_and_value(lambda q: c * loss_fn(q, y))(pred)
            yield (X, y), pred, loss, vjp_fn(grad_pred)[0]

    def _validate_targets(self, pred: torch.Tensor, y: torch.Tensor) -> None:
        """Refuse cross-entropy targets outside ``[0, C)`` that are not
        ``ignore_index``, on the host.

        Raises:
            ValueError: On any out-of-range target.
        """
        loss_fn = self._loss_fn
        if not isinstance(loss_fn, CrossEntropyLoss):
            return
        C = pred.shape[1]
        y_np = y.detach().cpu().numpy()
        valid = ((y_np >= 0) & (y_np < C)) | (y_np == loss_fn.ignore_index)
        if not valid.all():
            bad = np.unique(y_np[~valid])[:10]
            raise ValueError(
                f"Cross-entropy targets outside [0, {C}) that are not "
                f"ignore_index={loss_fn.ignore_index}: {bad.tolist()}."
            )

    def _check_deterministic(self, rtol: float = 5e-5, atol: float = 1e-6) -> None:
        """Two independent data passes must agree: total loss entrywise,
        total gradient by norm, and each batch when ``FIXED_DATA_ORDER``.

        Under a mesh the totals are compared after their sum over the data
        axis, and a batch that fails on one process fails on all of them.

        Raises:
            RuntimeError: On any detected non-determinism.
        """
        has_loss = self._loss_fn is not None
        tl1 = tl2 = tg1 = tg2 = None
        failure = None
        for (b1, pred1, loss1, grad1), (b2, pred2, loss2, grad2) in zip(
            self._batch_pred_loss_grad(), self._batch_pred_loss_grad()
        ):
            if self.FIXED_DATA_ORDER and failure is None:
                try:
                    self._check_deterministic_batch(
                        b1, b2, pred1, pred2, loss1, loss2, grad1, grad2, rtol, atol
                    )
                except RuntimeError as err:
                    failure = err
            if has_loss:
                tl1 = loss1 if tl1 is None else tl1 + loss1
                tl2 = loss2 if tl2 is None else tl2 + loss2
                tg1 = grad1 if tg1 is None else tree_add(tg1, grad1)
                tg2 = grad2 if tg2 is None else tree_add(tg2, grad2)
        if self._shards.any(failure is not None) and failure is None:
            failure = RuntimeError("Check for deterministic batch failed on another process.")
        if failure is not None:
            raise failure
        if has_loss:
            if tl1 is None:
                raise RuntimeError("Empty dataset in determinism check.")
            tl1, tl2, tg1, tg2 = self._shards.all_reduce((tl1, tl2, tg1, tg2))
            if not torch.allclose(tl1, tl2, rtol=rtol, atol=atol):
                raise RuntimeError("Check for deterministic total loss failed.")
            if not _tree_close(tg1, tg2, rtol, atol):
                raise RuntimeError("Check for deterministic total gradient failed.")

    @staticmethod
    def _check_deterministic_batch(
        b1, b2, pred1, pred2, loss1, loss2, grad1, grad2, rtol, atol
    ) -> None:
        """Per-batch comparison when ``FIXED_DATA_ORDER``.

        Raises:
            RuntimeError: On any per-batch mismatch.
        """
        (X1, y1), (X2, y2) = b1, b2
        if not _tree_close(X1, X2, rtol, atol):
            raise RuntimeError("Check for deterministic X failed.")
        if not _tree_close(y1, y2, rtol, atol):
            raise RuntimeError("Check for deterministic y failed.")
        if not _tree_close(pred1, pred2, rtol, atol):
            raise RuntimeError("Check for deterministic batch prediction failed.")
        if loss1 is not None:
            if not _tree_close(loss1, loss2, rtol, atol):
                raise RuntimeError("Check for deterministic batch loss failed.")
            if not _tree_close(grad1, grad2, rtol, atol):
                raise RuntimeError("Check for deterministic batch gradient failed.")


class CurvatureLinearOperator(EmpiricalRiskOperator):
    """Square operators in parameter space (Hessian, GGN, Fisher, ...)."""
