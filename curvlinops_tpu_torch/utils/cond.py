"""``torch.cond`` inside the port's own forwards.

The JAX package's ``lax.cond`` is one primitive that every transform
understands. Its PyTorch counterpart ``torch.cond`` is not usable as it is
where the port runs a model:

- eagerly it compiles its branches with dynamo, seconds for each call site;
- ``torch.func.jvp`` refuses it (``UncapturedHigherOrderOpError``), and
  ``torch.func.vjp``/``grad`` fail on a fake-tensor assertion, so the
  curvature operators could not differentiate a model that calls it;
- a ``TorchFunctionMode`` sees it only as the ``cond`` operator that the
  compiled program calls, after dynamo has run.

So the port's forwards run under :func:`cond_handler`, which swaps the
attribute ``torch.cond`` for a dispatcher while they run (a model that calls
``torch.cond(...)`` looks it up at call time) and hands every call, unpacked
by :func:`cond_operands`, to a handler:

- :func:`inline_cond`, entered by :func:`~curvlinops_tpu_torch.utils.misc.as_model_fn`
  (the curvature operators, the GGN diagonal, the Jacobians) and by KFAC's
  determinism probe: the taken branch when the predicate is concrete, and
  both branches joined by :func:`select` when it is batched under
  ``torch.func.vmap`` (JAX's vmap-of-cond semantics). An untaken branch's
  parameters then get zero rows, as JAX's ``dense_ggn`` gives them;
- the KFAC collector's handler (``kfac/collector.py``), which runs both
  branches, records the layers of each and selects (JAX's lower-to-select).

The swap is process-wide for the duration of the enclosed code, and is not
meant for threads that run models concurrently.
"""

from __future__ import annotations

import inspect
from contextlib import contextmanager
from typing import Any, Callable

import torch
from torch.utils import _pytree as pytree

from curvlinops_tpu_torch.utils.graphs import capturing

_ORIGINAL_COND = torch.cond
_SIGNATURE = inspect.signature(_ORIGINAL_COND)
_HANDLERS: list[Callable] = []  # the innermost is last


def cond_operands(*args, **kwargs) -> tuple[Any, Callable, Callable, tuple]:
    """``(pred, true_fn, false_fn, operands)`` of a ``torch.cond`` call's
    arguments, bound as ``torch.cond`` binds them."""
    bound = _SIGNATURE.bind(*args, **kwargs)
    bound.apply_defaults()
    a = bound.arguments
    return a["pred"], a["true_fn"], a["false_fn"], tuple(a["operands"])


def _dispatch(*args, **kwargs):
    if not _HANDLERS:
        return _ORIGINAL_COND(*args, **kwargs)
    return _HANDLERS[-1](*cond_operands(*args, **kwargs))


@contextmanager
def cond_handler(handler: Callable):
    """Route the enclosed code's ``torch.cond`` calls to
    ``handler(pred, true_fn, false_fn, operands)``."""
    _HANDLERS.append(handler)
    torch.cond = _dispatch
    try:
        yield
    finally:
        _HANDLERS.pop()
        if not _HANDLERS:
            torch.cond = _ORIGINAL_COND


def select(pred: torch.Tensor, on_true: Any, on_false: Any) -> Any:
    """The two branches' outputs joined leaf by leaf with ``torch.where``."""
    return pytree.tree_map(lambda a, b: torch.where(pred, a, b), on_true, on_false)


def predicate(pred) -> torch.Tensor:
    """``pred`` as a 0-d boolean tensor."""
    if not isinstance(pred, torch.Tensor):
        return torch.tensor(bool(pred))
    return pred.reshape(()).bool()


def concrete(pred) -> bool | None:
    """The predicate's value, or ``None`` if it has none yet (batched under
    ``vmap``, a fake tensor while a graph is traced, or a CUDA tensor while
    its stream is captured, where reading it is refused)."""
    if isinstance(pred, torch.Tensor) and capturing(pred.device):
        return None
    try:
        return bool(pred)
    except RuntimeError:
        return None


def _inline(pred, true_fn, false_fn, operands):
    taken = concrete(pred)
    if taken is None:
        return select(predicate(pred), true_fn(*operands), false_fn(*operands))
    return (true_fn if taken else false_fn)(*operands)


@contextmanager
def inline_cond():
    """Run the enclosed code's ``torch.cond`` calls inline (module
    docstring), so ``torch.func`` transforms and autograd see plain ops."""
    with cond_handler(_inline):
        yield
