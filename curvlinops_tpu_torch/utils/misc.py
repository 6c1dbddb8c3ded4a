"""Model-function plumbing and small library utilities.

PyTorch counterpart of ``curvlinops_tpu/utils/misc.py``. The JAX package's
``FrozenModelFn`` / ``unwrap_model_fn`` keep the non-differentiated
parameters out of jitted programs; here an ``nn.Module`` holds them itself:
the operators differentiate w.r.t. a dict of named parameters and apply the
module with ``torch.func.functional_call(model, params, (X,))``, so every
other parameter and buffer stays fixed. ``make_functional_call`` is that
adapter under the JAX package's name (which adapts flax and haiku modules
there), with a module's ``torch.cond`` calls inlined (``utils/cond.py``);
``allclose_report`` prints mismatching entries, ``split_list`` cuts a sequence into
chunks and ``full_float32_matmul`` turns TF32 off for the products it encloses.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Sequence

import numpy as np
import torch
from torch import nn

from curvlinops_tpu_torch.utils.cond import inline_cond


def as_model_fn(model: nn.Module | Callable) -> Callable[[Any, Any], torch.Tensor]:
    """``(params, X) -> prediction`` for an ``nn.Module`` (whose
    ``torch.cond`` calls run inline,
    :func:`~curvlinops_tpu_torch.utils.cond.inline_cond`, so that
    ``torch.func`` can differentiate it) or a plain callable, returned as it
    is (as the JAX package returns one).

    Raises:
        ValueError: If it is neither.
    """
    if isinstance(model, nn.Module):
        def model_fn(params, X):
            with inline_cond():
                return torch.func.functional_call(model, params, (X,))

        return model_fn
    if callable(model):
        return model
    raise ValueError(
        "model must be an nn.Module or a callable (params, X) -> prediction, "
        f"got {type(model).__name__}."
    )


# the JAX package's name for the adapter (there it adapts flax and haiku
# modules); an nn.Module takes a partial dict of named parameters
make_functional_call = as_model_fn


def _numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def allclose_report(
    a, b, rtol: float = 1e-5, atol: float = 1e-8, max_entries: int = 10
) -> bool:
    """Like ``np.allclose`` (tensors or arrays), but print the mismatching
    entries on failure."""
    a, b = _numpy(a), _numpy(b)
    close = np.allclose(a, b, rtol=rtol, atol=atol)
    if not close:
        bad = ~np.isclose(a, b, rtol=rtol, atol=atol)
        for idx in np.argwhere(bad)[:max_entries]:
            key = tuple(int(i) for i in idx)
            print(f"  mismatch at {key}: {a[key]} vs {b[key]}")
        print(f"  ... {int(bad.sum())}/{bad.size} entries differ")
    return bool(close)


def split_list(xs: Sequence, sizes: Sequence[int]) -> list:
    """Split a sequence into consecutive chunks of the given sizes.

    Raises:
        ValueError: If the sizes do not sum to the sequence length.
    """
    if sum(sizes) != len(xs):
        raise ValueError(f"sizes {sizes} do not sum to len {len(xs)}.")
    out, start = [], 0
    for size in sizes:
        out.append(list(xs[start : start + size]))
        start += size
    return out


@contextlib.contextmanager
def full_float32_matmul():
    """Run the enclosed float32 matmuls at full float32 precision (TF32 off),
    restoring the caller's ``torch.backends.cuda.matmul.allow_tf32`` after.

    The counterpart of ``precision=HIGHEST`` on a JAX product: a user's
    ``torch.backends.cuda.matmul.allow_tf32 = True`` would otherwise round
    the operands to 10 mantissa bits on the card. It sets the same (legacy)
    flag it reads: torch refuses to read either API's flag once both were
    set (``set_float32_matmul_precision`` here, then a caller's
    ``allow_tf32``, made the next ``get_float32_matmul_precision()`` raise).
    """
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
