"""Scan-stacked layer stacks: the port's form of ``jax.lax.scan`` over blocks.

The JAX package stacks ``n_layer`` identical blocks into one ``lax.scan``
whose parameters carry a leading ``n_layer`` axis. Here a stacked block
holds its dense weights in :class:`StackedLinear` modules
(``weight [L, d_out, d_in]``, ``bias [L, d_out]``), called with the layer
index, and :func:`scan` applies ``body(carry, layer)`` for
``layer = 0 .. L-1`` in a Python loop. The math is that of the unrolled
``h0 .. h{L-1}`` blocks.

KFAC sees each :class:`StackedLinear` call as the use of one slice of a
stacked weight (``kfac/collector.py``), and each of the ``L`` slices gets its
own Kronecker block, held batched as ``[L, d, d]`` factors. A layer module
that is not stacked but called inside the loop shares its weight across the
iterations (weight tying). While a KFAC forward runs, it watches every
:func:`scan` call through :func:`watch_scans`: a parameter in the carry, a
parameter that flows out of the loop and a scan inside a scan are refused
there, as the JAX collector refuses them.

``remat`` is the port's ``jax.checkpoint`` of the block body: each block
call goes through :class:`_RematBlock`, a ``torch.autograd.Function`` that
keeps only the block's inputs (the carry and the layer's parameter slices)
and recomputes the block when a pullback needs its internals. Reverse mode
therefore holds one block's internals at a time, under plain autograd and
under every ``torch.func`` transform the curvature operators use: ``grad``
and ``vjp`` (the pullback recomputes the block through ``torch.func.vjp``),
``jvp`` (the tangent goes through ``torch.func.jvp`` of the block), ``jvp``
of ``grad`` (the recompute and pullback inside ``backward`` are themselves
differentiable in forward mode) and ``vmap`` (a generated rule), as well as
``make_fx`` traces and CUDA-graph capture. The Function calls the block
on one-layer stacks of the slices at layer 0 (``torch.func.functional_call``),
so a pullback returns slice-sized gradients, and a forward hook on a stacked
layer sees the index 0 there. ``torch.func.functionalize``
cannot run a ``torch.autograd.Function``; there the loop raises and names
``remat_blocks=False``, and never runs the blocks without remat in its
place.

Two places run the plain loop, and the result is the same:

- a KFAC forward (:func:`watch_scans` active): a recompute in backward would
  fire the collector's forward hooks a second time and record every layer
  use twice (the JAX collector inlines ``jax.checkpoint`` for the same
  reason);
- a forward that no reverse mode records (no ``torch.func.grad``/``vjp``
  level, and plain autograd off or no input requiring grad: forward mode
  alone, ``torch.no_grad``): it holds no block internals to begin with, so
  each block runs once, as ``jax.checkpoint``'s forward-mode rule runs it.
"""

from __future__ import annotations

import math
from contextlib import contextmanager
from functools import partial
from typing import Any, Callable

import torch
import torch.nn.functional as F
from torch import nn
from torch.autograd import forward_ad
from torch._C import _functorch
from torch._C._functorch import TransformType
from torch._functorch import eager_transforms
from torch._functorch.pyfunctorch import (
    retrieve_all_functorch_interpreters,
    retrieve_current_functorch_interpreter,
)

_WATCHERS: list = []  # observers of scan calls; the innermost is last


class StackedLinear(nn.Module):
    """``L`` dense layers in one module: ``weight [L, d_out, d_in]`` and
    ``bias [L, d_out]``; ``forward(x, layer)`` applies slice ``layer``."""

    def __init__(self, stack: int, in_features: int, out_features: int, bias: bool = True):
        super().__init__()
        self.stack, self.in_features, self.out_features = stack, in_features, out_features
        self.weight = nn.Parameter(torch.empty(stack, out_features, in_features))
        self.bias = nn.Parameter(torch.empty(stack, out_features)) if bias else None
        # each slice initialised as nn.Linear initialises its weight and bias
        for w in self.weight:
            nn.init.kaiming_uniform_(w, a=math.sqrt(5))
        if self.bias is not None:
            nn.init.uniform_(self.bias, -(in_features**-0.5), in_features**-0.5)

    def forward(self, x: torch.Tensor, layer: int) -> torch.Tensor:  # noqa: D102
        return F.linear(x, self.weight[layer], None if self.bias is None else self.bias[layer])


@contextmanager
def watch_scans(watcher):
    """Let ``watcher`` see every :func:`scan` call of the enclosed forward:
    ``watcher.enter(carry, length)`` before the loop and
    ``watcher.exit(carry)`` after it; the loop runs without ``remat``."""
    _WATCHERS.append(watcher)
    try:
        yield
    finally:
        _WATCHERS.pop()


def _call_block(block: nn.Module, names: tuple[str, ...], carry, *slices):
    """``block(carry, layer)`` with its stacked parameters replaced by one
    layer's ``slices``: each enters as a stack of one, called at layer 0."""
    params = {n: s.unsqueeze(0) for n, s in zip(names, slices)}
    return torch.func.functional_call(block, params, (carry, 0))


class _RematBlock(torch.autograd.Function):
    """One block call that keeps only its inputs; see the module docstring."""

    generate_vmap_rule = True

    @staticmethod
    def forward(block, names, carry, *slices):  # noqa: D102
        return _call_block(block, names, carry, *slices)

    @staticmethod
    def setup_context(ctx, inputs, output):  # noqa: D102
        block, names, carry, *slices = inputs
        ctx.block, ctx.names = block, names
        ctx.save_for_backward(carry, *slices)
        ctx.save_for_forward(carry, *slices)

    @staticmethod
    def backward(ctx, grad_out):  # noqa: D102
        block = partial(_call_block, ctx.block, ctx.names)
        saved = ctx.saved_tensors
        interpreter = _functorch.peek_interpreter_stack()
        level = None if interpreter is None else interpreter.level()
        if interpreter is None or interpreter.key() != TransformType.Grad or not any(
            _functorch.maybe_get_level(t) == level for t in saved
        ):
            _, pull = torch.func.vjp(block, *saved)
            return (None, None, *pull(grad_out))
        # a live torch.func.grad/vjp level runs this backward with
        # create_graph=True, so that the levels below it keep recording; its
        # own record of the recompute would hold every block's internals
        # until the transform returns. The pullback runs one level down
        # (the levels below record it as usual) and its results re-enter
        # this level as constants: nothing differentiates them here again.
        with retrieve_current_functorch_interpreter().lower():
            _, pull = torch.func.vjp(block, *(_functorch._unwrap_for_grad(t, level)
                                              for t in saved))
            grads = pull(_functorch._unwrap_for_grad(grad_out, level))
        return (None, None, *(_functorch._wrap_for_grad(g, level) for g in grads))

    @staticmethod
    def jvp(ctx, _block_t, _names_t, *tangents):  # noqa: D102
        primals = ctx.saved_tensors
        tangents = tuple(
            torch.zeros_like(p) if t is None else t for p, t in zip(primals, tangents)
        )
        block = partial(_call_block, ctx.block, ctx.names)
        if forward_ad._current_level < 0 or eager_transforms.JVP_NESTING > 0:
            return torch.func.jvp(block, primals, tangents)[1]
        # plain forward AD (torch.autograd.forward_ad) has its one dual level
        # open, and torch.func.jvp would open a second: the tangent is the
        # pullback's own pullback instead (the pullback is linear in its
        # cotangent)
        out, pull = torch.func.vjp(block, *primals)
        return torch.func.vjp(pull, torch.zeros_like(out))[1](tangents)[0]


def _base(t: torch.Tensor) -> torch.Tensor:
    """``t`` under every ``torch.func`` wrapper (they report
    ``requires_grad=False`` whatever the tensor beneath them records)."""
    while _functorch.is_functorch_wrapped_tensor(t) or _functorch.is_batchedtensor(t):
        t = _functorch.get_unwrapped(t)
    return t


def _reverse_mode_records(tensors) -> bool:
    """Whether a reverse mode records the ops on ``tensors``: a
    ``torch.func.grad``/``vjp`` level, or plain autograd.

    Raises:
        RuntimeError: Under ``torch.func.functionalize``, which cannot run
            :class:`_RematBlock`.
    """
    keys = [i.key() for i in retrieve_all_functorch_interpreters()]
    if TransformType.Functionalize in keys:
        raise RuntimeError(
            "remat_blocks cannot run under torch.func.functionalize: it "
            "recomputes each block in a torch.autograd.Function, which "
            "functionalize does not run. Build the model with remat_blocks=False."
        )
    return TransformType.Grad in keys or (
        torch.is_grad_enabled() and any(_base(t).requires_grad for t in tensors)
    )


def _stacked_parameters(body, length: int) -> tuple[tuple[str, ...], list[torch.Tensor]]:
    """The names and tensors of ``body``'s parameters, each stacked over
    ``length`` layers.

    Raises:
        ValueError: For a ``body`` that is not a module, a parameter without
            the leading ``length`` axis, or a buffer.
    """
    if not isinstance(body, nn.Module):
        raise ValueError("scan(remat=True) takes an nn.Module body; pass remat_blocks=False.")
    named = list(body.named_parameters())
    flat = [n for n, p in named if p.dim() == 0 or p.shape[0] != length]
    if flat or list(body.buffers()):
        raise ValueError(
            f"scan(remat=True) needs every parameter of the body stacked over the "
            f"{length} layers and no buffers; {flat or 'its buffers'} are not. Pass "
            "remat_blocks=False."
        )
    return tuple(n for n, _ in named), [p for _, p in named]


def scan(body: Callable[[Any, int], Any], carry: Any, length: int, remat: bool = False) -> Any:
    """``carry = body(carry, layer)`` for ``layer`` in ``range(length)``.

    With ``remat``, ``body`` is a module whose parameters all carry the
    leading ``length`` axis and ``carry`` a tensor; each call keeps only its
    inputs for reverse mode and recomputes the block in its pullback (see the
    module docstring for the two places the loop runs plainly).

    Raises:
        ValueError: With ``remat``, for a ``body`` that is not such a module.
        RuntimeError: With ``remat``, under ``torch.func.functionalize``.
    """
    watcher = _WATCHERS[-1] if _WATCHERS else None
    if watcher is not None:
        watcher.enter(carry, length)
    remat = remat and watcher is None
    if remat:
        names, stacked = _stacked_parameters(body, length)
        remat = _reverse_mode_records((carry, *stacked))
    for layer in range(length):
        if remat:
            carry = _RematBlock.apply(body, names, carry, *(p[layer] for p in stacked))
        else:
            carry = body(carry, layer)
    if watcher is not None:
        watcher.exit(carry)
    return carry
