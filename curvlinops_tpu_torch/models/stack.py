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

``remat`` checkpoints each iteration with ``torch.utils.checkpoint``
(non-reentrant) so that reverse mode keeps one block's internals alive at a
time. Two places run the loop without it, and the result is the same:

- a KFAC forward (:func:`watch_scans` active): a recompute in backward would
  fire the collector's forward hooks a second time and record every layer
  use twice;
- any ``torch.func`` transform: ``torch.func.grad``/``vjp`` refuse the saved
  tensor hooks that checkpointing installs, and under ``torch.func.jvp`` on
  CUDA its custom Function has no forward-mode rule. The curvature
  operators, which run under these transforms, therefore apply the blocks
  without recomputation.
"""

from __future__ import annotations

import math
from contextlib import contextmanager
from typing import Any, Callable

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

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


def _under_functorch_transform() -> bool:
    return torch._C._functorch.peek_interpreter_stack() is not None


def scan(body: Callable[[Any, int], Any], carry: Any, length: int, remat: bool = False) -> Any:
    """``carry = body(carry, layer)`` for ``layer`` in ``range(length)``.

    ``remat`` checkpoints each call of ``body`` under plain autograd; see the
    module docstring for where the loop runs without it.
    """
    watcher = _WATCHERS[-1] if _WATCHERS else None
    if watcher is not None:
        watcher.enter(carry, length)
    remat = (
        remat and watcher is None and torch.is_grad_enabled()
        and not _under_functorch_transform()
    )
    for layer in range(length):
        if remat:
            carry = checkpoint(body, carry, layer, use_reentrant=False)
        else:
            carry = body(carry, layer)
    if watcher is not None:
        watcher.exit(carry)
    return carry
