"""Layer discovery and layer IO for KFAC on ``nn.Module`` models.

PyTorch counterpart of ``curvlinops_tpu/kfac/collector.py``, for
``nn.Conv2d``, ``nn.Linear``, scan-stacked
:class:`~curvlinops_tpu_torch.models.stack.StackedLinear` and ``nn.Embedding``
layers. The JAX collector analyses a jaxpr because a functional model has no
modules; here the layers are the modules that own the covered parameters,
and their IO comes from forward hooks:

1. every covered parameter must be the ``weight`` or ``bias`` of a module of
   a recognised type (``nn.Linear``, ``nn.Conv2d``, the ResNet's
   :class:`~curvlinops_tpu_torch.models.resnet.SamePadConv2d`, whose
   forward is known, ``StackedLinear`` or ``nn.Embedding``), in a
   configuration the math supports (no dilation, no groups, zero padding
   mode; a plain lookup table);
2. one verification forward runs under a ``TorchFunctionMode`` that sees
   every torch call: a covered parameter passed to any call outside its own
   module's forward (``x @ self.fc.weight.T`` in a parent module, a stacked
   weight transposed before its ``StackedLinear`` call) is refused, as is a
   covered weight no layer call consumes. Reading only its metadata (shape,
   dtype, ...) is allowed. The same forward watches every
   :func:`~curvlinops_tpu_torch.models.stack.scan` call and refuses a
   covered parameter in the loop carry, one that flows out of the loop, and
   a scan inside a scan (the JAX collector's refusals);
3. :meth:`TracedModel.apply_with_io` reruns the forward with hooks that
   record every layer call's input (token ids for a lookup) and add a zero
   ``delta`` leaf to its output, so one batched backward w.r.t. the deltas
   yields every layer's output gradient (the counterpart of the JAX
   tap-and-vjp re-interpreter). Scans run without ``remat`` there: a
   recompute in backward would fire the hooks twice.

Modules are matched by identity of their parameter tensors, so a module
called twice, or two modules sharing one weight, give several uses of one
weight (weight sharing is merged downstream, ``build_groups``); a layer
module called inside a scan loop shares its weight across the iterations
(JAX's ``("shared", L)`` use). A ``StackedLinear`` call records the slice it
applied (``meta["slice"]``, JAX's ``("stacked", L)`` use), and
``build_groups`` requires each slice to be used once. Anything else is
refused with ``ValueError``: never silently miscomputed.
"""

from __future__ import annotations

import operator
from dataclasses import dataclass, field
from typing import Any

import torch
from torch import nn
from torch.overrides import TorchFunctionMode
from torch.utils import _pytree as pytree

from curvlinops_tpu_torch.models.resnet import SamePadConv2d
from curvlinops_tpu_torch.models.stack import StackedLinear, watch_scans

# module types whose forward is known to be exactly conv2d / linear / a lookup
_CONV_TYPES = (nn.Conv2d, SamePadConv2d)
_LINEAR_TYPES = (nn.Linear, StackedLinear)
_EMBEDDING_TYPES = (nn.Embedding,)
# tensor metadata reads that do not use a parameter's values
_METADATA_PROPERTIES = {"shape", "dtype", "device", "ndim", "requires_grad", "is_cuda", "layout"}
_METADATA_METHODS = {torch.Tensor.size, torch.Tensor.dim, torch.Tensor.numel}


@dataclass
class LayerUse:
    """One call of a covered layer module."""

    layer_id: int
    name: str  # module name, e.g. "layer1.block0.conv1"
    kind: str  # 'dense' | 'conv' | 'embedding'
    weight_path: str  # name of the covered weight in ``params``
    meta: dict = field(default_factory=dict)
    bias_path: str | None = None  # name of the covered bias, if any


def _recognised(mod: nn.Module) -> str | None:
    if type(mod) in _CONV_TYPES:
        return "conv"
    if type(mod) in _LINEAR_TYPES:
        return "dense"
    if type(mod) in _EMBEDDING_TYPES:
        return "embedding"
    return None


def _conv_padding(mod: nn.Conv2d, h: int, w: int) -> tuple:
    """``((lo_h, hi_h), (lo_w, hi_w))`` zero padding of a conv module's call."""
    if isinstance(mod, SamePadConv2d):
        return mod.same_pads(h, w)
    if mod.padding == "valid":
        return ((0, 0), (0, 0))
    if mod.padding == "same":  # PyTorch puts the odd pixel at the end
        totals = [d * (k - 1) for d, k in zip(mod.dilation, mod.kernel_size)]
        return tuple((t // 2, t - t // 2) for t in totals)
    return tuple((p, p) for p in mod.padding)


def _config_problem(mod: nn.Module) -> str | None:
    """Why the math cannot handle this module's configuration, if it cannot."""
    if _recognised(mod) == "embedding":
        for attr in ("padding_idx", "max_norm"):
            if getattr(mod, attr) is not None:
                return f"{attr}={getattr(mod, attr)}"
        for attr in ("scale_grad_by_freq", "sparse"):
            if getattr(mod, attr):
                return f"{attr}=True"
        return None
    if _recognised(mod) != "conv":
        return None
    if tuple(mod.dilation) != (1, 1):
        return f"dilation {tuple(mod.dilation)}"
    if mod.groups != 1:
        return f"groups={mod.groups}"
    if mod.padding_mode != "zeros":
        return f"padding_mode={mod.padding_mode!r}"
    return None


def _use_meta(mod: nn.Module, args: tuple) -> dict:
    """A layer call's metadata; a ``StackedLinear`` call adds the slice it
    applied and the stack length, a lookup its vocabulary."""
    x = args[0]
    if isinstance(mod, StackedLinear):
        return {
            "d_in": mod.in_features, "d_out": mod.out_features,
            "slice": operator.index(args[1]), "stack": mod.stack,
        }
    if _recognised(mod) == "dense":
        return {"d_in": mod.in_features, "d_out": mod.out_features}
    if _recognised(mod) == "embedding":
        return {"vocab": mod.num_embeddings, "d_in": mod.num_embeddings, "d_out": mod.embedding_dim}
    kh, kw = mod.kernel_size
    return {
        "stride": tuple(mod.stride),
        "padding": _conv_padding(mod, x.shape[-2], x.shape[-1]),
        "kernel": (kh, kw),
        "dilation": tuple(mod.dilation),
        "groups": mod.groups,
        "C": mod.in_channels,
        "w_shape": tuple(mod.weight.shape),
    }


class _ReadGuard(TorchFunctionMode):
    """Records covered parameters passed to torch calls outside their module."""

    def __init__(self, covered: dict[int, str], active: list):
        super().__init__()
        self.covered, self.active = covered, active
        self.violations: dict[str, set] = {}

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        is_metadata = func in _METADATA_METHODS or (
            getattr(func, "__name__", "") == "__get__"
            and getattr(getattr(func, "__self__", None), "__name__", "") in _METADATA_PROPERTIES
        )
        if not is_metadata:
            owner = self.active[-1] if self.active else None
            for t in pytree.tree_leaves((args, kwargs)):
                name = self.covered.get(id(t)) if isinstance(t, torch.Tensor) else None
                if name is not None and not (
                    owner is not None and (owner.weight is t or owner.bias is t)
                ):
                    fname = getattr(func, "__name__", str(func))
                    self.violations.setdefault(name, set()).add(fname)
        return func(*args, **kwargs)


class _ScanWatch:
    """Watches the :func:`~curvlinops_tpu_torch.models.stack.scan` calls of
    one forward for covered parameters in the carry or flowing out of the
    loop, and for nested scans; :attr:`lengths` is the stack of open loops."""

    def __init__(self, covered: dict[int, str]):
        self.covered = covered
        self.lengths: list[int] = []
        self.problems: list[str] = []

    def _params_in(self, tree) -> list[str]:
        names = []
        for t in pytree.tree_leaves(tree):
            if isinstance(t, torch.Tensor):
                name = self.covered.get(id(t), self.covered.get(id(t._base)))
                if name is not None:
                    names.append(name)
        return names

    def enter(self, carry, length: int) -> None:  # noqa: D102
        if self.lengths:
            self.problems.append("  a scan inside a scan (nested stacks are not supported)")
        for name in self._params_in(carry):
            self.problems.append(f"  {name}: scan (parameter enters the loop carry)")
        self.lengths.append(length)

    def exit(self, carry) -> None:  # noqa: D102
        self.lengths.pop()
        for name in self._params_in(carry):
            self.problems.append(f"  {name}: scan (parameter flows out of the scan)")


class TracedModel:
    """Layer analysis and tappable forward of ``model`` at ``params``.

    Args:
        model: The ``nn.Module``; it is called as
            ``torch.func.functional_call(model, params, (X,))``.
        params: The parameters KFAC covers, by name (a subset of
            ``model.named_parameters()``); the module keeps the rest.
        X_example: Example input for the verification forward.

    Raises:
        ValueError: For a covered parameter that no recognised module owns,
            one read outside its module's call, a module configuration the
            math does not support, or a covered weight no layer call uses.
    """

    def __init__(self, model: nn.Module, params: dict[str, torch.Tensor], X_example: Any):
        self.model = model
        self.param_names = list(params)
        self._module_names = {}
        for name, mod in model.named_modules():
            self._module_names.setdefault(id(mod), name)

        problems = []
        owners = {}
        for name in self.param_names:
            mod_name, _, attr = name.rpartition(".")
            try:
                mod = model.get_submodule(mod_name)
            except AttributeError:
                mod = None
            if mod is None or _recognised(mod) is None or attr not in ("weight", "bias"):
                problems.append(
                    f"  {name}: not the weight/bias of an nn.Linear, nn.Conv2d, "
                    "StackedLinear or nn.Embedding"
                )
                continue
            why = _config_problem(mod)
            if why is not None:
                problems.append(f"  {name}: unsupported layer configuration ({why})")
                continue
            owners[name] = (mod, attr)
        for name, (mod, attr) in owners.items():
            if attr == "bias" and f"{name.rpartition('.')[0]}.weight" not in owners:
                problems.append(f"  {name}: a bias without its weight (bias-only KFAC is not ported)")
        if problems:
            raise ValueError(self._refusal(problems))

        # verification forward: discover the layer calls and watch every read
        self.layers: list[LayerUse] = []
        guard_active: list = []
        covered = {id(t): n for n, t in params.items()}
        guard = _ReadGuard(covered, guard_active)
        scans = _ScanWatch(covered)

        def on_call(mod, args, out):
            weight = covered.get(id(mod.weight))
            if weight is None:
                return
            bias = covered.get(id(mod.bias)) if getattr(mod, "bias", None) is not None else None
            try:
                meta = _use_meta(mod, args)
            except TypeError:
                problems.append(f"  {weight}: StackedLinear called with a layer index {args[1:]!r}")
                return
            if scans.lengths:
                meta["scan"] = scans.lengths[-1]  # called in a loop: shared over L
            self.layers.append(
                LayerUse(
                    len(self.layers), self._module_names[id(mod)], _recognised(mod),
                    weight, meta, bias,
                )
            )

        with torch.no_grad():
            out = self._forward(params, X_example, on_call, guard_active, guard, scans)
        self.output_shape = tuple(out.shape)  # the model output's, for EKFAC's 2d check
        problems.extend(scans.problems)

        used = {u.weight_path for u in self.layers} | {
            u.bias_path for u in self.layers if u.bias_path is not None
        }
        for name in self.param_names:
            if name in guard.violations:
                stacked = isinstance(owners[name][0], StackedLinear)
                problems.append(
                    f"  {name}: read outside its module's call by "
                    f"{sorted(guard.violations[name])}"
                    + (" (a scan-stacked weight must reach its StackedLinear call "
                       "unchanged: not reshaped or transposed)" if stacked else "")
                )
            elif name not in used:
                problems.append(f"  {name}: not consumed by any layer call")
        if problems:
            raise ValueError(self._refusal(problems))

    @staticmethod
    def _refusal(problems: list[str]) -> str:
        return (
            "KFAC supports parameters that are only used as the weight/bias of "
            "nn.Linear, nn.Conv2d, StackedLinear or nn.Embedding layers inside "
            "their own forward. Offending parameters:\n" + "\n".join(problems)
            + "\nPass only supported parameters to KFAC and leave the rest in "
            "the module."
        )

    def _forward(self, params, X, on_call, active: list, mode=None, scans=None):
        """Run the model with pre/post hooks on every recognised module and
        ``scans`` watching its scan loops (which then run without remat).

        ``on_call(mod, args, out)`` may return a replacement output.
        """

        def pre(mod, args):
            active.append(mod)

        def post(mod, args, out):
            active.pop()
            return on_call(mod, args, out)

        handles = []
        for mod in self.model.modules():
            if _recognised(mod) is not None:
                handles.append(mod.register_forward_pre_hook(pre))
                handles.append(mod.register_forward_hook(post))
        try:
            with watch_scans(scans or _ScanWatch({})):
                if mode is None:
                    return torch.func.functional_call(self.model, params, (X,))
                with mode:
                    return torch.func.functional_call(self.model, params, (X,))
        finally:
            for h in handles:
                h.remove()
            active.clear()

    def apply_with_io(
        self, params: dict[str, torch.Tensor], X: Any
    ) -> tuple[torch.Tensor, list[torch.Tensor], list[torch.Tensor]]:
        """Forward pass that taps every layer call.

        Returns:
            ``(prediction, inputs, deltas)``: per layer call, its (detached)
            input (token ids for a lookup) and the zero leaf added to its
            output. Gradients w.r.t. the deltas are the layers' output
            gradients.

        Raises:
            RuntimeError: If the layer calls differ from the traced ones.
        """
        detached = {n: p.detach() for n, p in params.items()}
        covered = {id(t) for t in detached.values()}
        inputs, deltas = [], []

        def on_call(mod, args, out):
            if id(mod.weight) not in covered:
                return None
            i = len(inputs)
            if i >= len(self.layers) or self._module_names[id(mod)] != self.layers[i].name:
                raise RuntimeError("The model's layer calls differ from the traced ones.")
            inputs.append(args[0].detach())
            delta = torch.zeros_like(out, requires_grad=True)
            deltas.append(delta)
            return out + delta

        with torch.enable_grad():
            pred = self._forward(detached, X, on_call, [])
        if len(inputs) != len(self.layers):
            raise RuntimeError("The model's layer calls differ from the traced ones.")
        return pred, inputs, deltas
