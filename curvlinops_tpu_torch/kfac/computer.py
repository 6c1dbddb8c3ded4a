"""KFAC Kronecker-factor computation.

PyTorch counterpart of ``curvlinops_tpu/kfac/computer.py``. The collector
finds the layers and taps their IO; per batch, one tapped forward gives the
layer inputs (input covariances ``aaT``, through the Hopper kernel for
eligible convs on CUDA under EXPAND), the grad outputs are drawn or computed
in closed form, and ONE batched backward over all ``V`` grad-output vectors
gives every layer's output gradients (gradient covariances ``ggT``).
EKFAC's correction pass and KFOC reuse the tapped forward and the batched
backward (:meth:`KFACComputer._layer_grads`). A use inside a ``torch.cond``
branch has its input covariance scaled by its gate (the taken indicator),
the kernel's output included; the untaken branch's output gradients are
exactly zero, so its blocks are exactly zero.

A scan-stacked weight (``StackedLinear``, ``models/stack.py``) forms one
group with ``stack = L``: each slice is its own Kronecker block, computed
from the call that applied it, and the factors are held batched as
``[L, d, d]``. An embedding group (``input_diag``) stores its input
covariance as the diagonal vector of token counts ``[V]``.

With ``mesh=`` every process computes the factors of its slice of each
batch (the conv kernel and the flash kernels launched on that slice; the
JAX package turns Pallas off under a mesh) and the accumulated factors are
summed over the mesh's data axis once per build. The dataset statistics,
the ``ignore_index`` rescale and the MC draws read the whole batch, so the
factors equal the mesh-less build's up to the order of the sums.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable

import torch

from curvlinops_tpu_torch.curvature.ef import flatten_prediction, flatten_target
from curvlinops_tpu_torch.curvature.loss_hessian import (
    FisherType,
    KFACType,
    make_grad_output_fn,
    mean_rescale,
)
from curvlinops_tpu_torch.kfac import math as kmath
from curvlinops_tpu_torch.kfac.collector import LayerUse, TracedModel
from curvlinops_tpu_torch.kfac.kernels import (
    conv_cov_kernel_supported,
    conv_input_covariance,
)
from curvlinops_tpu_torch.losses import SUPPORTED_LOSSES, CrossEntropyLoss
from curvlinops_tpu_torch.parallel.mesh import DataShards, gather_params
from curvlinops_tpu_torch.ops.base import close_by_norm
from curvlinops_tpu_torch.risk import (
    _num_loss_terms_in_batch,
    batch_generator,
    default_batch_size,
)
from curvlinops_tpu_torch.utils.misc import as_model_fn


@dataclass
class ParamGroup:
    """A canonical-space block: a weight (with its uses), a bias, or both.

    ``stack > 0`` marks a scan-stacked group: ``uses[l]`` applied slice
    ``l``, and the canonical block is ``stack`` Kronecker blocks batched into
    ``[L, d_out, d_out]`` / ``[L, d_in, d_in]`` factors. ``input_diag`` marks
    an embedding group, whose input covariance is a diagonal ``[d_in]``
    vector.
    """

    name: str
    weight_path: str | None
    bias_path: str | None
    uses: list  # LayerUse objects providing the IO
    joint: bool  # weight and bias share one block (bias column appended)
    d_in: int  # canonical input dim (incl. the bias column when joint)
    d_out: int
    stack: int = 0  # stack length of a scan-stacked group, else 0
    input_diag: bool = False  # embedding group: aaT is a diagonal [d_in] vector

    @property
    def key(self) -> tuple:
        """Hashable identifier."""
        return (self.weight_path, self.bias_path)


def _use_dims(u: LayerUse) -> tuple[int, int]:
    if u.kind == "conv":
        O, C, *kernel = u.meta["w_shape"]
        return C * math.prod(kernel), O
    return u.meta["d_in"], u.meta["d_out"]


def _stacked_uses(key: str, uses: list[LayerUse]) -> tuple[list[LayerUse], int]:
    """The uses of a scan-stacked weight in slice order, and the stack length.

    Raises:
        ValueError: Unless every slice is used exactly once.
    """
    stack = uses[0].meta["stack"]
    by_slice = sorted(uses, key=lambda u: u.meta.get("slice", -1))
    if [u.meta.get("slice") for u in by_slice] != list(range(stack)):
        raise ValueError(
            f"Weight {key} is scan-stacked ({stack} slices) but has {len(uses)} "
            "uses; tying a stacked leaf with other layers is not supported "
            "(each slice must be applied exactly once)."
        )
    return by_slice, stack


def _canonical_layout(u: LayerUse, shape: tuple) -> torch.Tensor:
    """Where a dense or conv use puts each element of its ``shape``-d weight
    in the canonical ``[d_out, d_in]`` block."""
    W = torch.arange(math.prod(shape)).reshape(shape)
    if u.kind == "conv":
        return kmath.canonical_conv_weight(W, u.meta)
    return kmath.canonical_dense_weight(W, u.meta)


def build_groups(layers: list[LayerUse], separate_weight_and_bias: bool) -> list[ParamGroup]:
    """Merge layer uses into parameter groups (uses of one weight merge).

    A bias-only use (``weight_path is None``) forms a bias block of its own;
    the uses of one bias merge (the JAX package's ``build_groups``).

    Raises:
        ValueError: On a weight tied across layer kinds, canonical shapes or
            canonical layouts, conflicting biases in a tied joint group, a
            scan-stacked weight whose slices are not each used exactly once,
            or a bias-only bias tied across outputs of different widths.
    """
    by_weight: dict[str, list[LayerUse]] = {}
    bias_only: dict[str, list[LayerUse]] = {}
    for use in layers:
        if use.weight_path is None:
            bias_only.setdefault(use.bias_path, []).append(use)
        else:
            by_weight.setdefault(use.weight_path, []).append(use)

    groups: list[ParamGroup] = []
    for key, uses in by_weight.items():
        stack = 0
        if "stack" in uses[0].meta:
            uses, stack = _stacked_uses(key, uses)
        input_diag = uses[0].kind == "embedding"
        if len({u.kind for u in uses}) > 1:
            raise ValueError(f"Weight {key} is tied across layer kinds.")
        d_in, d_out = _use_dims(uses[0])
        if any(_use_dims(u) != (d_in, d_out) for u in uses[1:]):
            raise ValueError(
                f"Weight {key} is tied across layers with different canonical shapes."
            )
        if uses[0].kind in ("dense", "conv") and not stack and len(uses) > 1:
            shape = uses[0].meta.get("w_leaf_shape", uses[0].meta.get("w_shape", (d_out, d_in)))
            layout = _canonical_layout(uses[0], shape)
            if any(not torch.equal(_canonical_layout(u, shape), layout) for u in uses[1:]):
                raise ValueError(
                    f"Weight {key} is tied across layers that contract different "
                    "axes of it (e.g. x @ W and x @ W.T); KFAC cannot merge their "
                    "covariances."
                )
        bias_paths = sorted({u.bias_path for u in uses if u.bias_path is not None})
        name = uses[0].name if stack else "+".join(u.name for u in uses)
        if separate_weight_and_bias:
            groups.append(
                ParamGroup(name, key, None, uses, False, d_in, d_out, stack, input_diag)
            )
            for bp in bias_paths:
                bias_uses = [u for u in uses if u.bias_path == bp]
                bias_name = name if stack else "+".join(u.name for u in bias_uses)
                groups.append(
                    ParamGroup(bias_name + ".bias", None, bp, bias_uses, False, 1, d_out, stack)
                )
        else:
            if len(bias_paths) > 1:
                raise ValueError(
                    f"Tied group {name} has conflicting biases under joint "
                    "weight+bias treatment; use separate_weight_and_bias=True."
                )
            bias_path = bias_paths[0] if bias_paths else None
            joint = bias_path is not None
            groups.append(
                ParamGroup(
                    name, key, bias_path, uses, joint, d_in + joint, d_out, stack, input_diag
                )
            )
    for key, uses in bias_only.items():
        d_outs = {u.meta["d_out"] for u in uses}
        if len(d_outs) > 1:
            raise ValueError(
                f"Bias {key} is tied across outputs with different feature counts "
                f"{sorted(d_outs)}; KFAC cannot merge their blocks."
            )
        name = "+".join(u.name for u in uses)
        groups.append(ParamGroup(name + ".bias", None, key, uses, False, 1, d_outs.pop()))
    return groups


def rows_not_batch_major(groups: list[ParamGroup]) -> list[str]:
    """The uses whose rows merge data in an order not proven batch-major
    (``meta["merged_rows"]`` without ``meta["batch_major"]``)."""
    return [
        u.name for g in groups for u in g.uses
        if u.meta.get("merged_rows") and not u.meta.get("batch_major")
    ]


class KFACComputer:
    """Accumulates per-group ``aaT`` / ``ggT`` Kronecker factors over a dataset.

    ``kfac_approx`` is ``expand`` or ``reduce``. ``use_kernel`` routes
    eligible float32 and bfloat16 conv input covariances through the Hopper
    kernel under EXPAND (REDUCE takes the averaged patches, float64 the
    plain path); ``"auto"`` means "iff the parameters are on a CUDA device".
    ``mesh`` and ``data_axis`` split every batch over a mesh axis (see the
    module docstring); ``DTensor`` parameters are gathered whole.
    """

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
        if not isinstance(loss_fn, SUPPORTED_LOSSES):
            raise ValueError(
                f"Loss must be one of {[c.__name__ for c in SUPPORTED_LOSSES]}."
            )
        fisher_type = FisherType(fisher_type)
        if fisher_type != FisherType.MC and mc_samples != 1:
            raise ValueError(f"mc_samples={mc_samples} requires fisher_type=FisherType.MC.")
        self.mesh, self.data_axis = mesh, data_axis
        self._shards = DataShards(mesh, data_axis)
        if mesh is not None:
            params = gather_params(params)
        self.model, self.loss_fn, self.params = model, loss_fn, params
        self.data = data
        self.fisher_type, self.mc_samples = fisher_type, mc_samples
        self.kfac_approx = KFACType(kfac_approx)
        self.separate_weight_and_bias = separate_weight_and_bias
        self.seed = seed
        self.device = next(iter(params.values())).device
        if use_kernel == "auto":
            use_kernel = self.device.type == "cuda"
        self.use_kernel = bool(use_kernel)
        self.batch_size_fn = batch_size_fn or default_batch_size
        self._traced_cache: dict = {}

        if num_data is None or num_per_example_loss_terms is None:
            n_acc, t_acc = 0, 0
            for X, y in data:
                n_acc += self.batch_size_fn(X)
                t_acc += _num_loss_terms_in_batch(loss_fn, y)
            if num_data is None:
                num_data = n_acc
            if num_per_example_loss_terms is None:
                if t_acc % num_data != 0:
                    raise ValueError("Loss terms not divisible by the number of data points.")
                num_per_example_loss_terms = t_acc // num_data
        self.num_data = num_data
        self.num_per_example_loss_terms = num_per_example_loss_terms

        self.groups = build_groups(
            self._get_traced(self.first_input()).layers, separate_weight_and_bias
        )
        if any(g.input_diag for g in self.groups) and self.kfac_approx != KFACType.EXPAND:
            raise ValueError(
                "Embedding layers support kfac_approx=KFACType.EXPAND only "
                "(averaging one-hot inputs over the sharing axis destroys the "
                "exact-diagonal covariance structure)."
            )
        if self.kfac_approx == KFACType.REDUCE:
            self.require_batch_major("KFACType.REDUCE")
        self._check_deterministic = check_deterministic

    def require_batch_major(self, what: str) -> None:
        """Refuse ``what``, which averages or sums per datum, on uses whose
        merged rows are not proven to be grouped by datum.

        Raises:
            ValueError: Naming those uses.
        """
        names = rows_not_batch_major(self.groups)
        if names:
            raise ValueError(
                f"{what} needs each layer's rows grouped by datum, but the rows of "
                f"{names} merge the batch axis with others in an order not proven "
                "batch-major (a view of all of a [batch, ...] tensor whose batch axis "
                "is outermost in memory); use KFACType.EXPAND KFAC, or keep the "
                "batch axis leading."
            )

    def first_input(self) -> Any:
        """This process's slice of the first batch's input (the whole input
        without a mesh)."""
        X0, _ = next(iter(self.data))
        return self._shards.shard(X0, self.device)

    def batches(self):
        """Yield ``(X, y, generator, correction)`` per batch: this process's
        slice of the batch, the batch's generator (seen through the slice
        under a mesh) and the loss correction of the slice with the whole
        batch's ``ignore_index`` rescale (:func:`mean_rescale`)."""

        def make(idx):
            return batch_generator(self.seed, idx, self.device)

        for _, y, Xs, ys, gen in self._shards.batches(self.data, self.device, make):
            yield Xs, ys, gen, self._batch_correction(Xs) * mean_rescale(self.loss_fn, y)

    def _get_traced(self, X: torch.Tensor) -> TracedModel:
        key = (tuple(X.shape), X.dtype)
        if key not in self._traced_cache:
            self._traced_cache[key] = TracedModel(
                self.model, self.params, X, batch_size=self.batch_size_fn(X)
            )
        return self._traced_cache[key]

    def _unflatten_rows(self, G_rows: torch.Tensor, pred_shape: tuple) -> torch.Tensor:
        """``[V, L, C]`` grad-output rows -> ``[V, *pred_shape]``."""
        V = G_rows.shape[0]
        if isinstance(self.loss_fn, CrossEntropyLoss) and len(pred_shape) > 2:
            B, C = pred_shape[0], pred_shape[1]
            return G_rows.reshape(V, B, *pred_shape[2:], C).movedim(-1, 2)
        return G_rows.reshape(V, *pred_shape)

    def _input_covariance(self, x: torch.Tensor, use: LayerUse, bias_pad) -> tuple:
        if use.kind == "embedding":  # one-hot inputs: exact diagonal (counts)
            dtype = self.params[use.weight_path].dtype
            return kmath.embedding_input_counts(x, use.meta["vocab"], dtype), x.numel() // x.shape[0]
        if (
            self.use_kernel
            and use.kind == "conv"
            and self.kfac_approx == KFACType.EXPAND
            and x.dtype in (torch.float32, torch.bfloat16)  # the kernel's dtypes
            and conv_cov_kernel_supported(tuple(x.shape), use.meta)
        ):
            # fused patch extraction + covariance: no [B, S, d] patch tensor
            return conv_input_covariance(x, use.meta, bias_pad)
        return kmath.input_covariance(x, use.kind, use.meta, self.kfac_approx, bias_pad)

    @staticmethod
    def _bias_pad(group: ParamGroup, use: LayerUse) -> float | None:
        """The constant input column of a joint group (0 for a use without
        the bias), or ``None``."""
        return None if not group.joint else (1.0 if use.bias_path else 0.0)

    @staticmethod
    def slices(group: ParamGroup) -> list[list[LayerUse]]:
        """The uses behind each Kronecker block of a group: one list per
        slice of a stacked group, else all uses in one list."""
        return [[u] for u in group.uses] if group.stack else [group.uses]

    @staticmethod
    def stack_slices(group: ParamGroup, parts: list):
        """Per-slice results stacked along a leading axis for a stacked
        group (tuples slot by slot), else the one result."""
        if not group.stack:
            return parts[0]
        if isinstance(parts[0], tuple):
            return tuple(torch.stack(slot) for slot in zip(*parts))
        return torch.stack(parts)

    def _group_inputs(self, inputs: list, group: ParamGroup, uses: list) -> torch.Tensor:
        """A weight group's inputs from ``uses`` in sharing format
        ``[B, S, d_in]`` (the uses concatenated along ``S``, the bias column
        appended when joint); an embedding group's token ids ``[B, S]``."""
        if group.input_diag:
            parts = [inputs[u.layer_id].reshape(inputs[u.layer_id].shape[0], -1) for u in uses]
        else:
            parts = [
                kmath.input_to_sharing_format(
                    inputs[u.layer_id], u.kind, u.meta, self.kfac_approx, self._bias_pad(group, u)
                )
                for u in uses
            ]
        return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)

    def _group_grads(self, grads: list, uses: list) -> torch.Tensor:
        """The output gradients of ``uses`` in sharing format ``[V, B, S, d_out]``."""
        parts = [
            kmath.grad_to_sharing_format(grads[u.layer_id], u.kind, u.meta, self.kfac_approx)
            for u in uses
        ]
        return parts[0] if len(parts) == 1 else torch.cat(parts, dim=2)

    def _layer_grads(self, pred, deltas, y, generator) -> list:
        """Draw (or form) the grad outputs and run ONE batched backward over
        all ``V`` of them.

        Returns:
            Per layer call its output gradients ``[V, B, *out]``.
        """
        loss_fn = self.loss_fn
        rows = flatten_prediction(loss_fn, pred.detach())
        y_rows = flatten_target(loss_fn, y)
        grad_output_fn = make_grad_output_fn(loss_fn, self.fisher_type, self.mc_samples)
        G_rows = grad_output_fn(rows, y_rows, generator).movedim(1, 0)  # [V, L, C]
        if loss_fn.reduction == "mean":
            G_rows = G_rows / rows.shape[0]
        G_pred = self._unflatten_rows(G_rows, tuple(pred.shape))

        def vjp(g_pred):
            grads = torch.autograd.grad(pred, deltas, g_pred, retain_graph=True, allow_unused=True)
            return [torch.zeros_like(d) if g is None else g for g, d in zip(grads, deltas)]

        if G_pred.shape[0] == 1:
            return [g[None] for g in vjp(G_pred[0])]
        # torch.func.vmap, not is_grads_batched: the latter's legacy batching
        # hands batched tensors to a custom Function's backward (flash
        # attention's kernels), bypassing its vmap rule
        return torch.func.vmap(vjp)(G_pred)

    def _batch_factors(self, traced, X, y, generator, correction) -> tuple[dict, dict]:
        pred, inputs, deltas, gates = traced.apply_with_io(self.params, X)

        def input_cov(group, uses):
            cov, S_total = None, 0
            for u in uses:
                cov_u, S_u = self._input_covariance(
                    inputs[u.layer_id], u, self._bias_pad(group, u)
                )
                # a cond-gated use: an untaken branch contributes an exactly
                # zero block (the gate is 1 outside conds); every datum still
                # counts in the normalisation
                gate = gates[u.layer_id]
                if isinstance(gate, torch.Tensor):
                    cov_u = cov_u * gate.to(cov_u.dtype)
                cov = cov_u if cov is None else cov + cov_u
                S_total += S_u
            return cov / (self.num_data * S_total)

        aaT = {
            gi: self.stack_slices(group, [input_cov(group, uses) for uses in self.slices(group)])
            for gi, group in enumerate(self.groups)
            if group.weight_path is not None  # a bias block has no input covariance
        }
        if self.fisher_type == FisherType.FORWARD_ONLY:
            return aaT, {}  # identity ggT is attached after the data loop

        grads = self._layer_grads(pred, deltas, y, generator)
        ggT = {
            gi: self.stack_slices(group, [
                kmath.gradient_covariance(self._group_grads(grads, uses), correction)
                for uses in self.slices(group)
            ])
            for gi, group in enumerate(self.groups)
        }
        return aaT, ggT

    def _batch_correction(self, X) -> float:
        """The loss correction of one batch (see :func:`kmath.loss_correction`);
        the ``ignore_index`` rescale is applied by :meth:`batches`."""
        return kmath.loss_correction(
            self.batch_size_fn(X),
            self.num_per_example_loss_terms,
            self.loss_fn.reduction,
            self.num_data,
        )

    def compute(self) -> tuple[dict, dict, list[ParamGroup]]:
        """Accumulate factors over the dataset.

        Returns:
            ``(input_covariances, gradient_covariances, groups)`` keyed by
            group index.
        """
        if self._check_deterministic:
            self._determinism_probe()

        aaT_acc: dict = {}
        ggT_acc: dict = {}
        for X, y, gen, correction in self.batches():
            aaT, ggT = self._batch_factors(self._get_traced(X), X, y, gen, correction)
            for acc, new in ((aaT_acc, aaT), (ggT_acc, ggT)):
                for gi, val in new.items():
                    acc[gi] = val if gi not in acc else acc[gi] + val
        aaT_acc, ggT_acc = self._shards.all_reduce((aaT_acc, ggT_acc))

        if self.fisher_type == FisherType.FORWARD_ONLY:
            dtype = next(iter(self.params.values())).dtype
            for gi, group in enumerate(self.groups):
                eye = torch.eye(group.d_out, dtype=dtype, device=self.device)
                ggT_acc[gi] = eye.repeat(group.stack, 1, 1) if group.stack else eye
        return aaT_acc, ggT_acc, self.groups

    def _determinism_probe(self) -> None:
        """Two passes of total loss and gradient must agree.

        The JAX package compares the gradients entrywise (rtol 5e-5, atol
        1e-6). On a GPU, cuDNN's weight-gradient kernels sum with atomics, so
        entries near zero differ from run to run by more than that; here each
        gradient is compared by norm, ``||g1 - g2|| <= 5e-5 ||g2|| + 1e-6``,
        which still catches non-deterministic data or models (shuffling,
        dropout), whose differences are of the gradient's own size. Under a
        mesh each pass runs on this process's slices and the totals are
        summed over the data axis before they are compared.

        Raises:
            RuntimeError: If the two passes disagree.
        """

        model_fn = as_model_fn(self.model)  # torch.cond inlined

        def one_pass():
            params = {n: p.detach().requires_grad_(True) for n, p in self.params.items()}
            total_loss, total_grad = None, None
            for X, y, _, _ in self.batches():
                loss = self.loss_fn(model_fn(params, X), y)
                grad = (  # a parameter an untaken cond branch holds gets a zero gradient
                    torch.autograd.grad(loss, list(params.values()), allow_unused=True,
                                        materialize_grads=True)
                    if loss.requires_grad else [torch.zeros_like(p) for p in params.values()]
                )
                total_loss = loss.detach() if total_loss is None else total_loss + loss.detach()
                total_grad = (
                    list(grad) if total_grad is None
                    else [a + b for a, b in zip(total_grad, grad)]
                )
            return total_loss, total_grad

        with torch.enable_grad():
            l1, g1 = one_pass()
            l2, g2 = one_pass()
        l1, g1, l2, g2 = self._shards.all_reduce((l1, g1, l2, g2))
        if not torch.allclose(l1, l2, rtol=5e-5, atol=1e-6):
            raise RuntimeError("Check for deterministic total loss failed.")
        if not all(close_by_norm(a, b, 5e-5, 1e-6) for a, b in zip(g1, g2)):
            raise RuntimeError("Check for deterministic total gradient failed.")
