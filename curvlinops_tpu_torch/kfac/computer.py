"""KFAC Kronecker-factor computation.

PyTorch counterpart of ``curvlinops_tpu/kfac/computer.py``. The collector
finds the layers and taps their IO; per batch, one tapped forward gives the
layer inputs (input covariances ``aaT``, through the Hopper kernel for
eligible convs on CUDA), the grad outputs are drawn or computed in closed
form, and ONE batched backward over all ``V`` grad-output vectors gives
every layer's output gradients (gradient covariances ``ggT``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
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
from curvlinops_tpu_torch.risk import _num_loss_terms_in_batch, default_batch_size


@dataclass
class ParamGroup:
    """A canonical-space block: a weight (with its uses), a bias, or both."""

    name: str
    weight_path: str | None
    bias_path: str | None
    uses: list  # LayerUse objects providing the IO
    joint: bool  # weight and bias share one block (bias column appended)
    d_in: int  # canonical input dim (incl. the bias column when joint)
    d_out: int

    @property
    def key(self) -> tuple:
        """Hashable identifier."""
        return (self.weight_path, self.bias_path)


def _use_dims(u: LayerUse) -> tuple[int, int]:
    if u.kind == "conv":
        O, C, kh, kw = u.meta["w_shape"]
        return C * kh * kw, O
    return u.meta["d_in"], u.meta["d_out"]


def build_groups(layers: list[LayerUse], separate_weight_and_bias: bool) -> list[ParamGroup]:
    """Merge layer uses into parameter groups (uses of one weight merge).

    Raises:
        ValueError: On a weight tied across layer kinds or canonical shapes,
            or conflicting biases in a tied joint group.
    """
    by_weight: dict[str, list[LayerUse]] = {}
    for use in layers:
        by_weight.setdefault(use.weight_path, []).append(use)

    groups: list[ParamGroup] = []
    for key, uses in by_weight.items():
        if len({u.kind for u in uses}) > 1:
            raise ValueError(f"Weight {key} is tied across layer kinds.")
        d_in, d_out = _use_dims(uses[0])
        if any(_use_dims(u) != (d_in, d_out) for u in uses[1:]):
            raise ValueError(
                f"Weight {key} is tied across layers with different canonical shapes."
            )
        bias_paths = sorted({u.bias_path for u in uses if u.bias_path is not None})
        name = "+".join(u.name for u in uses)
        if separate_weight_and_bias:
            groups.append(ParamGroup(name, key, None, uses, False, d_in, d_out))
            for bp in bias_paths:
                bias_uses = [u for u in uses if u.bias_path == bp]
                groups.append(
                    ParamGroup(
                        "+".join(u.name for u in bias_uses) + ".bias",
                        None, bp, bias_uses, False, 1, d_out,
                    )
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
                ParamGroup(name, key, bias_path, uses, joint, d_in + joint, d_out)
            )
    return groups


def batch_generator(seed: int, batch_index: int, device: torch.device) -> torch.Generator:
    """Generator for one batch: ``seed`` folded with the batch index, so a
    rebuild draws the same MC samples for every batch."""
    state = np.random.SeedSequence([seed, batch_index]).generate_state(1, np.uint64)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(state[0]))
    return gen


class KFACComputer:
    """Accumulates per-group ``aaT`` / ``ggT`` Kronecker factors over a dataset.

    ``use_kernel`` routes eligible conv input covariances through the Hopper
    kernel; ``"auto"`` means "iff the parameters are on a CUDA device".
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
    ):
        if not isinstance(loss_fn, SUPPORTED_LOSSES):
            raise ValueError(
                f"Loss must be one of {[c.__name__ for c in SUPPORTED_LOSSES]}."
            )
        fisher_type = FisherType(fisher_type)
        if KFACType(kfac_approx) != KFACType.EXPAND:
            raise NotImplementedError("kfac_approx='reduce' is not ported yet.")
        if fisher_type != FisherType.MC and mc_samples != 1:
            raise ValueError(f"mc_samples={mc_samples} requires fisher_type=FisherType.MC.")
        self.model, self.loss_fn, self.params = model, loss_fn, params
        self.data = data
        self.fisher_type, self.mc_samples = fisher_type, mc_samples
        self.kfac_approx = KFACType.EXPAND
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

        X0, _ = next(iter(data))
        self.groups = build_groups(self._get_traced(X0).layers, separate_weight_and_bias)
        self._check_deterministic = check_deterministic

    def _get_traced(self, X: torch.Tensor) -> TracedModel:
        key = (tuple(X.shape), X.dtype)
        if key not in self._traced_cache:
            self._traced_cache[key] = TracedModel(self.model, self.params, X)
        return self._traced_cache[key]

    def _unflatten_rows(self, G_rows: torch.Tensor, pred_shape: tuple) -> torch.Tensor:
        """``[V, L, C]`` grad-output rows -> ``[V, *pred_shape]``."""
        V = G_rows.shape[0]
        if isinstance(self.loss_fn, CrossEntropyLoss) and len(pred_shape) > 2:
            B, C = pred_shape[0], pred_shape[1]
            return G_rows.reshape(V, B, *pred_shape[2:], C).movedim(-1, 2)
        return G_rows.reshape(V, *pred_shape)

    def _input_covariance(self, x: torch.Tensor, use: LayerUse, bias_pad) -> tuple:
        if (
            self.use_kernel
            and use.kind == "conv"
            and conv_cov_kernel_supported(tuple(x.shape), use.meta)
        ):
            # fused patch extraction + covariance: no [B, S, d] patch tensor
            cov, S = conv_input_covariance(x, use.meta, bias_pad)
            return cov.float(), S
        return kmath.input_covariance(x, use.kind, use.meta, self.kfac_approx, bias_pad)

    def _batch_factors(self, traced, X, y, generator, correction) -> tuple[dict, dict]:
        pred, inputs, deltas = traced.apply_with_io(self.params, X)

        aaT = {}
        for gi, group in enumerate(self.groups):
            if group.weight_path is None:
                continue  # bias block: no input covariance
            cov, S_total = None, 0
            for u in group.uses:
                bias_pad = None if not group.joint else (1.0 if u.bias_path else 0.0)
                cov_u, S_u = self._input_covariance(inputs[u.layer_id], u, bias_pad)
                cov = cov_u if cov is None else cov + cov_u
                S_total += S_u
            aaT[gi] = cov / (self.num_data * S_total)

        if self.fisher_type == FisherType.FORWARD_ONLY:
            return aaT, {}  # identity ggT is attached after the data loop

        loss_fn = self.loss_fn
        rows = flatten_prediction(loss_fn, pred.detach())
        y_rows = flatten_target(loss_fn, y)
        grad_output_fn = make_grad_output_fn(loss_fn, self.fisher_type, self.mc_samples)
        G_rows = grad_output_fn(rows, y_rows, generator).movedim(1, 0)  # [V, L, C]
        if loss_fn.reduction == "mean":
            G_rows = G_rows / rows.shape[0]
        # ignore_index: convert the static loss-term count to the masked one
        corr_eff = correction * mean_rescale(loss_fn, y)
        G_pred = self._unflatten_rows(G_rows, tuple(pred.shape))

        # ONE batched backward over all V grad-output vectors
        if G_pred.shape[0] == 1:
            grads = torch.autograd.grad(pred, deltas, G_pred[0], allow_unused=True)
            grads = [None if g is None else g[None] for g in grads]
        else:
            grads = torch.autograd.grad(
                pred, deltas, G_pred, is_grads_batched=True, allow_unused=True
            )
        V = G_pred.shape[0]
        grads = [
            torch.zeros((V, *d.shape), dtype=d.dtype, device=d.device) if g is None else g
            for g, d in zip(grads, deltas)
        ]

        ggT = {}
        for gi, group in enumerate(self.groups):
            parts = [
                kmath.grad_to_sharing_format(grads[u.layer_id], u.kind, u.meta, self.kfac_approx)
                for u in group.uses
            ]
            g = parts[0] if len(parts) == 1 else torch.cat(parts, dim=2)
            ggT[gi] = kmath.gradient_covariance(g, corr_eff)
        return aaT, ggT

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
        for idx, (X, y) in enumerate(self.data):
            correction = kmath.loss_correction(
                self.batch_size_fn(X),
                self.num_per_example_loss_terms,
                self.loss_fn.reduction,
                self.num_data,
            )
            aaT, ggT = self._batch_factors(
                self._get_traced(X), X, y,
                batch_generator(self.seed, idx, self.device), correction,
            )
            for acc, new in ((aaT_acc, aaT), (ggT_acc, ggT)):
                for gi, val in new.items():
                    acc[gi] = val if gi not in acc else acc[gi] + val

        if self.fisher_type == FisherType.FORWARD_ONLY:
            dtype = next(iter(self.params.values())).dtype
            for gi, group in enumerate(self.groups):
                ggT_acc[gi] = torch.eye(group.d_out, dtype=dtype, device=self.device)
        return aaT_acc, ggT_acc, self.groups

    def _determinism_probe(self) -> None:
        """Two passes of total loss and gradient must agree.

        The JAX package compares the gradients entrywise (rtol 5e-5, atol
        1e-6). On a GPU, cuDNN's weight-gradient kernels sum with atomics, so
        entries near zero differ from run to run by more than that; here each
        gradient is compared by norm, ``||g1 - g2|| <= 5e-5 ||g2|| + 1e-6``,
        which still catches non-deterministic data or models (shuffling,
        dropout), whose differences are of the gradient's own size.

        Raises:
            RuntimeError: If the two passes disagree.
        """

        def one_pass():
            params = {n: p.detach().requires_grad_(True) for n, p in self.params.items()}
            total_loss, total_grad = None, None
            for X, y in self.data:
                loss = self.loss_fn(torch.func.functional_call(self.model, params, (X,)), y)
                grad = torch.autograd.grad(loss, list(params.values()))
                total_loss = loss.detach() if total_loss is None else total_loss + loss.detach()
                total_grad = (
                    list(grad) if total_grad is None
                    else [a + b for a, b in zip(total_grad, grad)]
                )
            return total_loss, total_grad

        with torch.enable_grad():
            l1, g1 = one_pass()
            l2, g2 = one_pass()
        if not torch.allclose(l1, l2, rtol=5e-5, atol=1e-6):
            raise RuntimeError("Check for deterministic total loss failed.")
        if not all((a - b).norm() <= 5e-5 * b.norm() + 1e-6 for a, b in zip(g1, g2)):
            raise RuntimeError("Check for deterministic total gradient failed.")
