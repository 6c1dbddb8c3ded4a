"""Layer discovery and layer IO for KFAC on ``nn.Module`` models.

PyTorch counterpart of ``curvlinops_tpu/kfac/collector.py``. The JAX
collector analyses a jaxpr because a functional model has no modules; here
one verification forward runs with forward hooks on the recognised layer
modules and under a ``TorchFunctionMode`` that sees every torch call. A
covered parameter (one KFAC is asked to cover) may be used as:

1. the ``weight`` or ``bias`` of a module of a recognised type
   (``nn.Linear``, ``nn.Conv1d``, ``nn.Conv2d``, the ResNet's
   :class:`~curvlinops_tpu_torch.models.resnet.SamePadConv2d`, whose forward
   is known, :class:`~curvlinops_tpu_torch.models.stack.StackedLinear` or
   ``nn.Embedding``), inside that module's forward, in a configuration the
   math supports (zero padding mode, any dilation and groups; a plain lookup
   table). A covered bias whose module weight is not covered is a bias-only
   block (the JAX collector's ``exclude='weight'`` blocks, which need only
   the output gradients);
2. the weight of a dense function call outside such a module: the right
   operand of ``F.linear``, ``torch.matmul``/``@``, ``torch.mm`` or
   ``torch.addmm``, directly or through a view (``.T``, ``transpose``,
   ``permute``, ``reshape``, ``view``: any view that keeps all its elements
   and is a permutation of a reshape). The contraction is recorded as JAX's
   ``_canonicalize_dense`` records a ``dot_general``'s (``w_views``,
   ``w_contract``, ``w_free``), so ``x @ W.T`` and HuggingFace GPT-2's
   ``Conv1D`` (``addmm(b, x.view(-1, in), W)`` with ``W [in, out]``) are
   dense layers in the canonical ``[d_out, d_in]`` space. ``F.linear``'s
   ``bias`` and ``addmm``'s ``input`` pair as that use's bias;
   likewise the weight of ``F.conv1d``/``F.conv2d``, directly or through
   such a view (JAX's HWIO/OIHW kernels become a ``permute`` before the
   call), with any stride, dilation, groups and the padding ``"same"``,
   ``"valid"`` or integers (a crop, JAX's negative padding, is an ``F.pad``
   of the input before the call); its ``bias`` pairs as the use's bias.
   Grouped convs average their input over the channel groups, as the JAX
   package and the reference do;
3. a bias added onto a tensor by ``+``/``torch.add``, the ``bias`` of
   ``F.linear`` or the ``input`` of ``addmm``: onto a layer's output it
   pairs as that layer's bias; onto any other tensor whose trailing axis is
   the bias's size (and which does not descend from a covered weight's
   layer), it is a bias-only block.

Everything else is refused with ``ValueError``, never silently miscomputed:
any other call on a covered parameter (``W.sum()``, the weight as the left
operand, a contraction over the batch axis, a stacked weight read outside
its ``StackedLinear`` call), a bias added to a transformed output of a
covered layer, added twice to one output, of the wrong size, reordered or
broadcast off the feature axis, a bias-only block inside a scan, a bias
tied across different layers, and a covered weight no layer call consumes.
The same forward watches every :func:`~curvlinops_tpu_torch.models.stack.scan`
call and refuses a covered parameter in the loop carry, one that flows out
of the loop, and a scan inside a scan (the JAX collector's refusals). A
``torch._higher_order_ops.while_loop`` around a covered parameter is
refused, as the JAX collector refuses ``while``.

``torch.cond`` around layers is LOWERED TO SELECT, as the JAX collector
lowers ``lax.cond``: the forwards run under
:func:`~curvlinops_tpu_torch.utils.cond.cond_handler`, which runs both
branches eagerly under the same hooks and mode, tags every use recorded in
a branch with ``(cond_op, cond_branch)`` and returns the taken branch's
output through ``torch.where`` (no dynamo compile is paid). The tapped
forward gives each use a gate: 1 outside conds, and in a branch the
detached taken indicator, by which the factor pass scales the use's input
covariance; the untaken branch's output gradients vanish through the
select, so a layer that did not run contributes an exactly zero block.
Refused with a message naming ``cond``: a weight tied across branches or
between a branch and the outside, a bias-only block or an embedding lookup
in a branch, a covered parameter flowing out of the cond, a predicate
computed from a covered parameter, a cond inside a scan or another cond
around covered parameters, and a scan inside a branch around them.

A function-level use whose leading axis is not the batch (HuggingFace's
``x.view(-1, in)`` gives ``B * T`` rows) is regrouped as ``[B, rows // B,
...]`` when the rows are a multiple of the batch: ``meta["merged_rows"]``
(a module's input keeps its leading axis as the batch axis, as the JAX
package keeps a ``dot_general``'s).
``meta["batch_major"]`` records whether the rows were proven to be grouped
by datum (a view of a ``[B, ...]`` tensor whose batch axis is outermost in
memory, or a use's output on such rows); REDUCE, EKFAC's correction and
KFOC need that and refuse without it.

:meth:`TracedModel.apply_with_io` reruns the forward with hooks (and, for
function-level uses, the same mode) that record every layer call's input
(token ids for a lookup) and add a zero ``delta`` leaf to its output, so one
batched backward w.r.t. the deltas yields every layer's output gradient
(the counterpart of the JAX tap-and-vjp re-interpreter). Scans run without
``remat`` there: a recompute in backward would fire the hooks twice.

Modules are matched by identity of their parameter tensors, so a module
called twice, or two modules sharing one weight, give several uses of one
weight (weight sharing is merged downstream, ``build_groups``); a layer
called inside a scan loop shares its weight across the iterations (JAX's
``("shared", L)`` use). A ``StackedLinear`` call records the slice it
applied (``meta["slice"]``, JAX's ``("stacked", L)`` use), and
``build_groups`` requires each slice to be used once.
"""

from __future__ import annotations

import operator
from dataclasses import dataclass, field
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn
from torch.overrides import TorchFunctionMode
from torch.utils import _pytree as pytree

from curvlinops_tpu_torch.models.resnet import SamePadConv2d
from curvlinops_tpu_torch.models.stack import StackedLinear, watch_scans
from curvlinops_tpu_torch.utils.cond import cond_handler, predicate, select

# module types whose forward is known to be exactly conv2d / linear / a lookup
_CONV_TYPES = (nn.Conv1d, nn.Conv2d, SamePadConv2d)
_LINEAR_TYPES = (nn.Linear, StackedLinear)
_EMBEDDING_TYPES = (nn.Embedding,)
# tensor metadata reads that do not use a parameter's values
_METADATA_PROPERTIES = {"shape", "dtype", "device", "ndim", "requires_grad", "is_cuda", "layout"}
_METADATA_METHODS = {torch.Tensor.size, torch.Tensor.dim, torch.Tensor.numel}
# dense calls whose right operand may be a covered weight
_MATMULS = {torch.matmul, torch.Tensor.matmul, torch.Tensor.__matmul__, torch.mm, torch.Tensor.mm}
_ADDMMS = {torch.addmm, torch.Tensor.addmm}
_ADDS = {torch.add, torch.Tensor.add, torch.Tensor.__add__, torch.Tensor.__radd__}
# conv calls whose weight may be a covered weight, by their number of spatial axes
_CONVS = {F.conv1d: 1, F.conv2d: 2}


@dataclass
class LayerUse:
    """One use of a covered weight (a layer call), or a bias-only block."""

    layer_id: int
    name: str  # module name ("layer1.block0.conv1"), or "<parameter>:<call>"
    kind: str  # 'dense' | 'conv' | 'embedding'
    weight_path: str | None  # name of the covered weight; None for bias-only
    meta: dict = field(default_factory=dict)
    bias_path: str | None = None  # name of the covered bias, if any
    cond_op: int | None = None  # number of the enclosing torch.cond call
    cond_branch: int | None = None  # its branch: 1 true, 0 false (JAX's index)


def _recognised(mod: nn.Module) -> str | None:
    if type(mod) in _CONV_TYPES:
        return "conv"
    if type(mod) in _LINEAR_TYPES:
        return "dense"
    if type(mod) in _EMBEDDING_TYPES:
        return "embedding"
    return None


def _conv_padding(padding, kernel: tuple, dilation: tuple) -> tuple:
    """``((lo, hi), ...)`` zero padding, one pair per spatial axis, of a
    conv call's ``padding`` (``"valid"``, ``"same"``, an int or a tuple)."""
    if padding == "valid":
        return ((0, 0),) * len(kernel)
    if padding == "same":  # PyTorch puts the odd pixel at the end
        totals = [d * (k - 1) for d, k in zip(dilation, kernel)]
        return tuple((t // 2, t - t // 2) for t in totals)
    if isinstance(padding, int):
        padding = (padding,) * len(kernel)
    return tuple((p, p) for p in padding)


def _conv_meta(kernel, stride, padding, dilation, groups: int, C: int, w_shape: tuple) -> dict:
    """A conv use's metadata; ``kernel`` fixes the number of spatial axes."""
    nd = len(kernel)

    def as_tuple(v) -> tuple:
        return (v,) * nd if isinstance(v, int) else tuple(v)

    kernel, dilation = tuple(kernel), as_tuple(dilation)
    return {
        "stride": as_tuple(stride),
        "padding": _conv_padding(padding, kernel, dilation),
        "kernel": kernel,
        "dilation": dilation,
        "groups": groups,
        "C": C,
        "w_shape": tuple(w_shape),
    }


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
    meta = _conv_meta(mod.kernel_size, mod.stride, mod.padding, mod.dilation, mod.groups,
                      mod.in_channels, mod.weight.shape)
    if isinstance(mod, SamePadConv2d):
        meta["padding"] = mod.same_pads(x.shape[-2], x.shape[-1])
    return meta


def _view_steps(v: torch.Tensor, root: torch.Tensor) -> tuple | None:
    """``v`` as ``root.reshape(...).permute(...).reshape(v.shape)``: the
    steps ``(("reshape", shape, in_shape), ("permute", dims, in_shape),
    ...)``, or ``None`` if ``v`` is not such a view of the contiguous
    ``root`` (it drops, repeats or offsets elements, or has another
    storage)."""
    if (
        not root.is_contiguous()
        or v.numel() != root.numel()
        or v.untyped_storage().data_ptr() != root.untyped_storage().data_ptr()
        or v.storage_offset() != root.storage_offset()
    ):
        return None
    axes = [d for d in range(v.ndim) if v.shape[d] != 1]
    order = sorted(axes, key=lambda d: -v.stride(d))
    expected = 1
    for d in reversed(order):
        if v.stride(d) != expected:
            return None
        expected *= v.shape[d]
    packed = tuple(v.shape[d] for d in order)
    inv = tuple(order.index(d) for d in axes)  # packed axes -> v's order
    unpermuted = tuple(v.shape[d] for d in axes)
    steps = []
    if packed != tuple(root.shape):
        steps.append(("reshape", packed, tuple(root.shape)))
    if inv != tuple(range(len(inv))):
        steps.append(("permute", inv, packed))
    if tuple(v.shape) != unpermuted:
        steps.append(("reshape", tuple(v.shape), unpermuted))
    return tuple(steps)


def _feature_layout(b: torch.Tensor, out_ndim: int, axis: int) -> bool:
    """Whether the bias operand ``b`` broadcast onto an ``out_ndim``-d output
    puts all of its elements on output axis ``axis``, in their own order."""
    lead = out_ndim - b.ndim
    if lead < 0:
        return False
    big = [d for d in range(b.ndim) if b.shape[d] != 1]
    if b.numel() == 1:
        return True
    return len(big) == 1 and big[0] + lead == axis and b.stride(big[0]) == 1


def _dense_call(func, args: tuple, kwargs: dict):
    """``(x, w, bias, w_contract, w_free)`` of a dense call whose right
    operand ``w`` may be a weight, or ``None``."""
    if func is F.linear:
        bound = list(args) + [None] * (3 - len(args))
        x, w, b = bound[0], bound[1], kwargs.get("bias", bound[2])
        if isinstance(w, torch.Tensor) and w.ndim == 2:
            return x, w, b, (1,), (0,)
        return None
    if func in _MATMULS and len(args) == 2 and not kwargs:
        x, w = args
        if isinstance(w, torch.Tensor) and w.ndim == 2:
            return x, w, None, (0,), (1,)
        return None
    if func in _ADDMMS and len(args) == 3:
        if any(kwargs.get(k, 1) != 1 for k in ("beta", "alpha")) or set(kwargs) - {"beta", "alpha"}:
            return None
        b, x, w = args
        return x, w, b, (0,), (1,)
    return None


def _conv_call(func, args: tuple, kwargs: dict):
    """``(x, w, bias, meta)`` of an ``F.conv1d``/``F.conv2d`` call, or ``None``."""
    nd = _CONVS.get(func)
    if nd is None:
        return None
    names = ("input", "weight", "bias", "stride", "padding", "dilation", "groups")
    bound = dict(zip(names, (None, None, None, 1, 0, 1, 1)))
    bound.update(zip(names, args))
    bound.update(kwargs)
    x, w = bound["input"], bound["weight"]
    if not (isinstance(x, torch.Tensor) and isinstance(w, torch.Tensor) and w.ndim == nd + 2):
        return None
    meta = _conv_meta(tuple(w.shape[2:]), bound["stride"], bound["padding"], bound["dilation"],
                      bound["groups"], x.shape[1] if x.ndim == nd + 2 else 0, w.shape)
    return x, w, bound["bias"], meta


def _add_operands(func, args: tuple, kwargs: dict):
    """The two tensor operands of a plain ``a + b``, or ``None``."""
    if func not in _ADDS or len(args) != 2 or kwargs.get("alpha", 1) != 1:
        return None
    if set(kwargs) - {"alpha"} or not all(isinstance(a, torch.Tensor) for a in args):
        return None
    return args


class _Calls(TorchFunctionMode):
    """Sees every torch call of one forward.

    In ``"trace"`` mode it records the function-level layer uses and bias
    adds, tracks views of the covered parameters and the values downstream
    of covered weights' layers, and records every other read of a covered
    parameter as a violation. In ``"tap"`` mode it only counts the calls
    that touch a covered parameter, and taps those the trace recorded as
    uses (``on_tap(seq, func, args, kwargs, out) -> out``). Both modes number
    those calls alike, so the tapped forward finds the traced uses by their
    number.
    """

    def __init__(self, traced: "TracedModel", covered: dict[str, torch.Tensor], active: list,
                 mode: str, taps: dict | None = None, on_tap=None):
        super().__init__()
        self.traced, self.mode, self.active = traced, mode, active
        self.taps = {} if taps is None else taps  # call number -> layer id
        self.on_tap = on_tap
        self.roots = dict(covered)
        self.tracked = {id(t): name for name, t in covered.items()}
        self._alive: list[torch.Tensor] = []
        self.seq = 0
        self.outputs: dict[int, tuple[int, torch.Tensor]] = {}  # layer outputs
        self.descended: dict[int, torch.Tensor] = {}
        self.batch_rows: set[int] = set()  # layer outputs whose merged rows are batch-major
        self.violations: dict[str, set] = {}
        # values computed from covered parameters outside any layer call
        self.param_values: dict[int, torch.Tensor] = {}

    # ------------------------------------------------------------------ #
    @staticmethod
    def _is_metadata(func) -> bool:
        return func in _METADATA_METHODS or (
            getattr(func, "__name__", "") == "__get__"
            and getattr(getattr(func, "__self__", None), "__name__", "") in _METADATA_PROPERTIES
        )

    def _name(self, t) -> str | None:
        return self.tracked.get(id(t)) if isinstance(t, torch.Tensor) else None

    def _stacked(self, name: str) -> bool:
        owner = self.traced._owners.get(name)
        return owner is not None and isinstance(owner[0], StackedLinear)

    def mark_output(self, out, layer_id: int) -> None:
        """Register ``out`` as the output of use ``layer_id``."""
        self.outputs[id(out)] = (layer_id, out)

    def _weight_output(self, t) -> bool:
        hit = self.outputs.get(id(t))
        return hit is not None and self.traced.layers[hit[0]].weight_path is not None

    @staticmethod
    def _mark(table: dict, out) -> None:
        for o in pytree.tree_leaves(out):
            if isinstance(o, torch.Tensor):
                table[id(o)] = o

    def _propagate(self, leaves: list, out) -> None:
        if any(id(t) in self.descended or self._weight_output(t) for t in leaves):
            self._mark(self.descended, out)
        if leaves and all(id(t) in self.param_values or id(t) in self.tracked for t in leaves):
            self._mark(self.param_values, out)  # computed from parameters alone

    def is_parameter(self, t) -> bool:
        """Whether ``t`` is a covered parameter, a view of one, or computed
        from one outside any layer call."""
        return self._name(t) is not None or id(t) in self.param_values

    def _refuse(self, name: str, why: str) -> None:
        self.traced.problems.append(f"  {name}: {why}")

    def _flag(self, names, func) -> None:
        fname = getattr(func, "__name__", str(func))
        for name in names:
            self.violations.setdefault(name, set()).add(fname)

    # ------------------------------------------------------------------ #
    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self._is_metadata(func):
            return func(*args, **kwargs)
        leaves = [t for t in pytree.tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
        hits = [t for t in leaves if id(t) in self.tracked]
        out = func(*args, **kwargs)
        if not hits:
            if self.mode == "trace":
                self._propagate(leaves, out)
            return out
        seq, self.seq = self.seq, self.seq + 1
        is_view = self._track_view(hits, out)
        if self.mode == "tap":
            return self.on_tap(seq, func, args, kwargs, out) if seq in self.taps else out
        names = {self._name(t) for t in hits}
        if self.traced.in_while:
            for name in names:
                self._refuse(name, "while_loop (a loop around a covered parameter is not "
                             "supported)")
        owner = self.active[-1] if self.active else None
        own = owner is not None and all(
            owner.weight is t or getattr(owner, "bias", None) is t for t in hits
        )  # the module's own call: its hook records it
        if not (is_view or own or self._classify(seq, func, args, kwargs, hits, out)):
            self._flag(names, func)
            self._mark(self.param_values, out)
        self._propagate(leaves, out)
        return out

    def _track_view(self, hits: list, out) -> bool:
        """Track ``out`` if it is a view of the one covered parameter the call
        read (a stacked weight's views are not followed: they are refused)."""
        if len(hits) != 1 or not isinstance(out, torch.Tensor) or out is hits[0]:
            return False
        name = self._name(hits[0])
        if self._stacked(name) or _view_steps(out, self.roots[name]) is None:
            return False
        self.tracked[id(out)] = name
        self._alive.append(out)  # its id stays its own while tracked
        return True

    def _classify(self, seq, func, args, kwargs, hits, out) -> bool:
        """Record a call on covered parameters; ``False`` flags it."""
        dense = _dense_call(func, args, kwargs)
        if dense is not None:
            return self._dense(seq, func, dense, out)
        conv = _conv_call(func, args, kwargs)
        if conv is not None:
            return self._conv(seq, func, conv, out)
        pair = _add_operands(func, args, kwargs)
        if pair is not None and len(hits) == 1 and any(t is hits[0] for t in pair):
            z = pair[1] if pair[0] is hits[0] else pair[0]
            return self._bias_add(seq, func, z, hits[0], out)
        return False

    def _rows_meta(self, x, name: str, out) -> dict:
        """``merged_rows``/``batch_major`` of a function-level use whose input
        ``x`` does not lead with the batch axis (empty if it does). Rows are
        proven batch-major when the contiguous ``x`` views all of a
        ``[B, ...]`` tensor whose batch axis is outermost in memory, or is
        the output of a use on proven rows; the use's output ``out`` then
        holds proven rows too."""
        B = self.traced.batch_size
        if B is None or not isinstance(x, torch.Tensor) or x.ndim == 0 or x.shape[0] == B:
            return {}
        rows = x.shape[0]
        if rows % B:
            self._refuse(name, f"the layer input's leading axis ({rows}) is not the batch "
                         f"({B}) or a multiple of it")
            return {}
        base = x._base
        proven = id(x) in self.batch_rows or (
            base is not None and base.ndim >= 1 and base.shape[0] == B
            and base.stride(0) * B == base.numel() and x.is_contiguous()
            and x.numel() == base.numel() and x.storage_offset() == base.storage_offset()
        )
        if proven:
            self.batch_rows.add(id(out))
        return {"merged_rows": True, "batch_major": proven}

    def _dense(self, seq, func, dense, out) -> bool:
        x, w, b, w_contract, w_free = dense
        wname, bname = self._name(w), self._name(b)
        fname = getattr(func, "__name__", str(func))
        if self._name(x) is not None or (wname is None and bname is None):
            return False
        if wname is not None and self._stacked(wname):
            return False
        if wname is None:  # a covered bias on a product with a closed-over weight
            if id(x) in self.descended or self._weight_output(x):
                self._refuse(bname, f"{fname} (bias added to a transformed output of a "
                             "covered layer; a layer bias must be added directly to the "
                             "layer output)")
                return True
            return self._bias_only(seq, bname, b, x, out, fname)
        if not isinstance(x, torch.Tensor) or x.ndim < 2:
            self._refuse(wname, f"{fname} (the contraction consumes the batch axis)")
            return True
        steps = _view_steps(w, self.roots[wname])
        d_in, d_out = w.shape[w_contract[0]], w.shape[w_free[0]]
        if bname is not None and (
            b.numel() != d_out or not _feature_layout(b, out.ndim, out.ndim - 1)
        ):
            self._refuse(bname, f"{fname} (bias with {b.numel()} elements is not the "
                         f"bias of a layer with {d_out} output features in identity order)")
            return True
        meta = {
            "d_in": d_in, "d_out": d_out, "w_contract": w_contract, "w_free": w_free,
            "w_views": steps, "w_leaf_shape": tuple(self.roots[wname].shape),
            "w_operand_shape": tuple(w.shape),
        }
        meta.update(self._rows_meta(x, wname, out))
        use = self.traced.add_use(f"{wname}:{fname}", "dense", wname, meta, bname)
        self.taps[seq] = use.layer_id
        self.mark_output(out, use.layer_id)
        return True

    def _conv(self, seq, func, conv, out) -> bool:
        x, w, b, meta = conv
        wname, bname = self._name(w), self._name(b)
        fname = getattr(func, "__name__", str(func))
        if wname is None or self._name(x) is not None or self._stacked(wname):
            return False
        if x.ndim != w.ndim or x.shape[0] != self.traced.batch_size:
            self._refuse(wname, f"{fname} (the conv input's leading axis is not the batch)")
            return True
        if bname is not None and not (b.ndim == 1 and b.stride(0) == 1
                                      and b.numel() == w.shape[0]):
            self._refuse(bname, f"{fname} (bias is not the conv's {w.shape[0]} output "
                         "channels in identity order)")
            return True
        meta.update({
            "w_views": _view_steps(w, self.roots[wname]),
            "w_leaf_shape": tuple(self.roots[wname].shape),
            "w_operand_shape": tuple(w.shape),
        })
        use = self.traced.add_use(f"{wname}:{fname}", "conv", wname, meta, bname)
        self.taps[seq] = use.layer_id
        self.mark_output(out, use.layer_id)
        return True

    def _bias_only(self, seq, bname, b, z, out, fname) -> bool:
        """A covered bias added onto ``z``, which no covered layer produced."""
        if self.traced.scans.lengths or self.traced.conds:
            self._refuse(bname, f"{fname} (a bias-only block inside a scan or a cond "
                         "branch is not supported; cover the layer's weight or move the "
                         "bias out)")
            return True
        if out.ndim < 2 or b.numel() != out.shape[-1]:
            trailing = out.shape[-1] if out.ndim else 0
            self._refuse(bname, f"{fname} (bias with {b.numel()} elements cannot be the "
                         f"bias of an output with {trailing} trailing features)")
            return True
        if not _feature_layout(b, out.ndim, out.ndim - 1):
            self._refuse(bname, f"{fname} (a reordered view of the bias is not a bias)")
            return True
        meta = {"d_in": 0, "d_out": b.numel(), "bias_only": True}
        meta.update(self._rows_meta(z, bname, out))
        use = self.traced.add_use(f"{bname}:{fname}", "dense", None, meta, bname)
        self.taps[seq] = use.layer_id
        self.mark_output(out, use.layer_id)
        return True

    def _bias_add(self, seq, func, z, b, out) -> bool:
        bname, fname = self._name(b), getattr(func, "__name__", str(func))
        if self._name(z) is not None:
            return False
        hit = self.outputs.get(id(z))
        if hit is None:
            if id(z) in self.descended:
                self._refuse(bname, f"{fname} (bias added to a transformed output of a "
                             "covered layer; a layer bias must be added directly to the "
                             "layer output)")
                return True
            return self._bias_only(seq, bname, b, z, out, fname)
        layer = self.traced.layers[hit[0]]
        if layer.kind == "embedding":
            self._refuse(bname, f"{fname} (a bias added to an embedding lookup is not "
                         "supported by KFAC)")
            return True
        if "scan" in layer.meta or "slice" in layer.meta:
            self._refuse(bname, f"{fname} (a bias added to a layer inside a scan is not "
                         "supported; use the module's own bias)")
            return True
        d_out = layer.meta["w_shape"][0] if layer.kind == "conv" and layer.weight_path else (
            layer.meta["d_out"]
        )
        if b.numel() != d_out:
            self._refuse(bname, f"{fname} (bias with {b.numel()} elements cannot be the "
                         f"bias of a layer with {d_out} output features)")
            return True
        axis = 1 if layer.kind == "conv" else out.ndim - 1
        if not _feature_layout(b, out.ndim, axis):
            self._refuse(bname, f"{fname} (bias does not map onto the layer's output-"
                         "feature axis with identity ordering)")
            return True
        if layer.bias_path is not None:
            why = ("bias added more than once to the same layer's output"
                   if layer.bias_path == bname else
                   f"conflicting biases of layer {layer.name} ({layer.bias_path})")
            self._refuse(bname, f"{fname} ({why})")
            return True
        layer.bias_path = bname
        self.mark_output(out, layer.layer_id)
        if id(z) in self.batch_rows:
            self.batch_rows.add(id(out))
        return True


class _ScanWatch:
    """Watches the :func:`~curvlinops_tpu_torch.models.stack.scan` calls of
    one forward for covered parameters in the carry or flowing out of the
    loop, for nested scans and, given the traced model, for a scan inside a
    cond branch around layers; :attr:`lengths` is the stack of open loops."""

    def __init__(self, covered: dict[int, str], traced: "TracedModel | None" = None):
        self.covered, self.traced = covered, traced
        self.lengths: list[int] = []
        self.problems: list[str] = []
        self._opened: list[int] = []  # layer counts when each loop opened

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
        self._opened.append(len(self.traced.layers) if self.traced is not None else 0)

    def exit(self, carry) -> None:  # noqa: D102
        self.lengths.pop()
        opened = self._opened.pop()
        for name in self._params_in(carry):
            self.problems.append(f"  {name}: scan (parameter flows out of the scan)")
        if self.traced is not None and self.traced.conds and len(self.traced.layers) > opened:
            self.problems.append("  scan (a scan inside a cond branch around layers is not "
                                 "supported)")


class TracedModel:
    """Layer analysis and tappable forward of ``model`` at ``params``.

    Args:
        model: The ``nn.Module``; it is called as
            ``torch.func.functional_call(model, params, (X,))``.
        params: The parameters KFAC covers, by name (a subset of
            ``model.named_parameters()``); the module keeps the rest.
        X_example: Example input for the verification forward.
        batch_size: The number of data in ``X_example`` (default: its
            leading dimension); a layer whose leading axis differs holds
            ``rows // batch_size`` rows per datum.

    Raises:
        ValueError: For a covered parameter used in any way but those of the
            module docstring, a module configuration the math does not
            support, or a covered weight no layer call uses.
    """

    def __init__(self, model: nn.Module, params: dict[str, torch.Tensor], X_example: Any,
                 batch_size: int | None = None):
        self.model = model
        self.param_names = list(params)
        if batch_size is None and isinstance(X_example, torch.Tensor):
            batch_size = int(X_example.shape[0])
        self.batch_size = batch_size
        self._module_names = {}
        for name, mod in model.named_modules():
            self._module_names.setdefault(id(mod), name)

        self.problems: list[str] = []  # why the parameters are refused
        self.conds: list[tuple] = []  # open cond branches: (cond_op, branch, gate)
        self.in_while = 0  # open while_loop calls
        self._cond_count = 0
        self._calls: _Calls | None = None  # the verification forward's mode
        self._owners = {}  # covered parameter -> (recognised module, attribute)
        for name in self.param_names:
            mod_name, _, attr = name.rpartition(".")
            try:
                mod = model.get_submodule(mod_name)
            except AttributeError:
                continue
            if _recognised(mod) is None or attr not in ("weight", "bias"):
                continue
            why = _config_problem(mod) if attr == "weight" else None
            if why is not None:
                self.problems.append(f"  {name}: unsupported layer configuration ({why})")
                continue
            self._owners[name] = (mod, attr)
        if self.problems:
            raise ValueError(self._refusal(self.problems))

        # verification forward: discover the layer uses and watch every read
        self.layers: list[LayerUse] = []
        active: list = []
        covered = {id(t): n for n, t in params.items()}
        self.scans = _ScanWatch(covered, self)
        calls = self._calls = _Calls(self, dict(params), active, "trace")

        def on_call(mod, args, out):
            weight = covered.get(id(mod.weight))
            bias = covered.get(id(mod.bias)) if getattr(mod, "bias", None) is not None else None
            if weight is None and bias is None:
                return
            kind, mod_name = _recognised(mod), self._module_names[id(mod)]
            if weight is None:  # bias-only: the module's weight is closed over
                if isinstance(mod, StackedLinear) or self.scans.lengths or self.conds:
                    self.problems.append(f"  {bias}: a bias-only block inside a scan or a cond "
                                         "branch, or of a scan-stacked layer, is not supported")
                    return
                d_out = mod.out_channels if kind == "conv" else mod.out_features
                meta = {"d_in": 0, "d_out": d_out, "bias_only": True}
                calls.mark_output(out, self.add_use(mod_name, kind, None, meta, bias).layer_id)
                return
            try:
                meta = _use_meta(mod, args)
            except TypeError:
                self.problems.append(
                    f"  {weight}: StackedLinear called with a layer index {args[1:]!r}"
                )
                return
            if kind == "embedding" and self.conds:
                # masking the lookup's token ids would miscount a token
                self.problems.append(f"  {weight}: cond (embedding lookup inside a cond branch)")
                return
            if self.scans.lengths:
                meta["scan"] = self.scans.lengths[-1]  # called in a loop: shared over L
            calls.mark_output(out, self.add_use(mod_name, kind, weight, meta, bias).layer_id)

        with torch.no_grad():
            out = self._forward(params, X_example, on_call, active, calls, self.scans)
        self.output_shape = tuple(out.shape)  # the model output's, for EKFAC's 2d check
        self._taps = calls.taps
        violations = calls.violations
        del calls  # drops the references to the forward's values
        self._calls = None
        self.problems.extend(self.scans.problems)
        self.problems.extend(self._tied_bias_problems())
        self.problems.extend(self._cond_tie_problems())

        used = {u.weight_path for u in self.layers} | {u.bias_path for u in self.layers}
        for name in self.param_names:
            owner = self._owners.get(name)
            if name in violations and (owner is not None or name in used):
                stacked = owner is not None and isinstance(owner[0], StackedLinear)
                self.problems.append(
                    f"  {name}: read outside its layer calls by {sorted(violations[name])}"
                    + (" (a scan-stacked weight must reach its StackedLinear call "
                       "unchanged: not reshaped or transposed)" if stacked else "")
                )
            elif name not in used and owner is None:
                extra = f" (used by {sorted(violations[name])})" if name in violations else ""
                self.problems.append(
                    f"  {name}: not the weight/bias of an nn.Linear, nn.Conv1d, "
                    f"nn.Conv2d, StackedLinear or nn.Embedding, nor of a dense or "
                    f"conv call{extra}"
                )
            elif name not in used:
                self.problems.append(f"  {name}: not consumed by any layer call")
        if self.problems:
            raise ValueError(self._refusal(self.problems))

    # ------------------------------------------------------------------ #
    def add_use(self, name: str, kind: str, weight: str | None, meta: dict,
                bias: str | None) -> LayerUse:
        """Append a layer use (verification forward only), tagged with the
        cond branch it runs in."""
        use = LayerUse(len(self.layers), name, kind, weight, meta, bias)
        if self.conds:
            use.cond_op, use.cond_branch = self.conds[-1][:2]
        self.layers.append(use)
        return use

    def _cond_tie_problems(self) -> list[str]:
        """A weight used in a cond branch and anywhere else (another branch,
        or outside) would need factors normalised across contexts."""
        contexts: dict[str, set] = {}
        for u in self.layers:
            if u.weight_path is not None:
                contexts.setdefault(u.weight_path, set()).add((u.cond_op, u.cond_branch))
        return [
            f"  {w}: cond (weight tied across cond branches or between a branch and the "
            "outside)"
            for w, c in contexts.items() if len(c) > 1 and any(op is not None for op, _ in c)
        ]

    def _on_cond(self, pred, true_fn, false_fn, operands):
        """A ``torch.cond`` call, lowered to select: both branches run under
        the forward's hooks and mode, the taken one's output is returned."""
        number, self._cond_count = self._cond_count, self._cond_count + 1
        calls, taken = self._calls, predicate(pred)
        if calls is not None and calls.is_parameter(pred):
            self.problems.append("  cond (parameter-derived predicate)")
        nested = bool(self.conds or self.scans.lengths)
        opened = len(self.layers)
        outs = {}
        for branch, fn in ((1, true_fn), (0, false_fn)):  # JAX's index: 1 is true
            gate = (taken if branch else ~taken).to(torch.float32).detach()
            self.conds.append((number, branch, gate))
            try:
                outs[branch] = fn(*operands)
            finally:
                self.conds.pop()
            if calls is not None:
                for name in {calls._name(t) for t in pytree.tree_leaves(outs[branch])} - {None}:
                    self.problems.append(f"  {name}: cond (parameter flows out of the cond)")
        if nested and len(self.layers) > opened:
            self.problems.append("  cond (nested inside a scan or a cond around layers)")
        return select(taken, outs[1], outs[0])

    def _on_while(self, cond_fn, body_fn, carried_inputs, additional_inputs=()):
        """A ``while_loop``, run as a Python loop; any covered parameter read
        inside is refused."""
        self.in_while += 1
        try:
            carry = tuple(carried_inputs)
            while bool(cond_fn(*carry, *additional_inputs)):
                carry = tuple(body_fn(*carry, *additional_inputs))
        finally:
            self.in_while -= 1
        return carry

    def _tied_bias_problems(self) -> list[str]:
        """A bias shared by layers of different weights (or by a layer and a
        bias-only block) would duplicate its canonical block."""
        owners: dict[str, set] = {}
        for u in self.layers:
            if u.bias_path is not None:
                owners.setdefault(u.bias_path, set()).add(u.weight_path or "<bias-only>")
        return [
            f"  {b}: add (bias tied across different layers; its canonical KFAC block "
            "would be duplicated)"
            for b, o in owners.items() if len(o) > 1
        ]

    @staticmethod
    def _refusal(problems: list[str]) -> str:
        return (
            "KFAC supports parameters that are only used as the weight/bias of "
            "nn.Linear, nn.Conv1d, nn.Conv2d, StackedLinear or nn.Embedding layers "
            "inside their own forward, as the right operand of F.linear, matmul, "
            "mm or addmm, as the weight of F.conv1d or F.conv2d, or as a bias "
            "added onto a layer output or onto an independent tensor (in a "
            "torch.cond branch too). Offending parameters:\n" + "\n".join(problems)
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
        self._cond_count = 0
        saved_while = torch._higher_order_ops.while_loop
        torch._higher_order_ops.while_loop = self._on_while
        try:
            with watch_scans(scans or _ScanWatch({})), cond_handler(self._on_cond):
                if mode is None:
                    return torch.func.functional_call(self.model, params, (X,))
                with mode:
                    return torch.func.functional_call(self.model, params, (X,))
        finally:
            torch._higher_order_ops.while_loop = saved_while
            for h in handles:
                h.remove()
            active.clear()

    def _by_batch(self, t: torch.Tensor, use: LayerUse) -> torch.Tensor:
        """``t`` with a merged-rows use's rows grouped by datum,
        ``[B, rows // B, ...]``."""
        if not use.meta.get("merged_rows"):
            return t
        return t.reshape(self.batch_size, t.shape[0] // self.batch_size, *t.shape[1:])

    def apply_with_io(
        self, params: dict[str, torch.Tensor], X: Any
    ) -> tuple[torch.Tensor, list, list[torch.Tensor], list]:
        """Forward pass that taps every layer use.

        Returns:
            ``(prediction, inputs, deltas, gates)``: per layer use, its
            (detached) input (token ids for a lookup; ``None`` for a
            bias-only block), the zero leaf added to its output, and its
            gate: ``1.0`` outside conds, and in a cond branch the detached
            float32 0-d taken indicator (JAX's ``layer_gates``). Gradients
            w.r.t. the deltas are the layers' output gradients (exactly 0 in
            an untaken branch). A dense use whose leading axis is not the
            batch has its input and delta regrouped as ``[B, rows // B, ...]``.

        Raises:
            RuntimeError: If the layer uses differ from the traced ones.
        """
        detached = {n: p.detach() for n, p in params.items()}
        covered = {id(t) for t in detached.values()}
        n = len(self.layers)
        inputs, deltas, gates = [None] * n, [None] * n, [1.0] * n
        position = [0]

        def tap(use: LayerUse, x, out):
            i = position[0]
            if i >= n or use is not self.layers[i]:
                raise RuntimeError("The model's layer calls differ from the traced ones.")
            position[0] += 1
            if use.weight_path is not None:
                inputs[i] = self._by_batch(x.detach(), use)
            shape = self._by_batch(out, use).shape
            delta = torch.zeros(shape, dtype=out.dtype, device=out.device, requires_grad=True)
            deltas[i] = delta
            if self.conds:
                gates[i] = self.conds[-1][2]
            return out + delta.reshape(out.shape)

        def on_call(mod, args, out):
            bias = getattr(mod, "bias", None)
            if id(mod.weight) not in covered and (bias is None or id(bias) not in covered):
                return None
            i = position[0]
            if i >= n or self._module_names[id(mod)] != self.layers[i].name:
                raise RuntimeError("The model's layer calls differ from the traced ones.")
            return tap(self.layers[i], args[0], out)

        mode = None
        if self._taps:
            def on_fn_tap(seq, func, args, kwargs, out):
                call = _dense_call(func, args, kwargs) or _conv_call(func, args, kwargs)
                return tap(self.layers[self._taps[seq]], None if call is None else call[0], out)

            mode = _Calls(self, detached, [], "tap", self._taps, on_fn_tap)
        with torch.enable_grad():
            pred = self._forward(detached, X, on_call, [], mode)
        if position[0] != n:
            raise RuntimeError("The model's layer calls differ from the traced ones.")
        return pred, inputs, deltas, gates
