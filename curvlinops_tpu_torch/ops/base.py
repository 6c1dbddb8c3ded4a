"""Matrix-free linear operators over tree spaces.

PyTorch counterpart of ``curvlinops_tpu/ops/base.py``. An operator maps a
tree of tensors (a dict of named parameters, a tuple of canonical blocks, or
a single tensor) to a tree. At the edge it also accepts flat ``[N]`` /
``[N, K]`` tensors or numpy arrays and answers in the caller's format.
Operator algebra (``+``, ``-``, scalar ``*``/``/``, ``@``-chaining,
adjoint, negation) is lazy, and composing operators over structurally
different spaces is refused.

The JAX package's ``traced()``, ``cached_program`` and ``FrozenModelFn``
exist to hoist large constants out of XLA programs and to cache compiled
programs. PyTorch runs eagerly and has nothing to hoist or compile, so here
``traced()`` returns the operator's own ``_matmat`` with no constants,
``invalidate_traced()`` does nothing and ``cached_program`` calls its
``build`` function every time. ``FrozenModelFn`` has no counterpart: a module keeps its
frozen tensors itself.
"""

from __future__ import annotations

from typing import Any, Callable, Sequence

import numpy as np
import torch
from torch.utils import _pytree as pytree

from curvlinops_tpu_torch.utils.flatten import (
    make_ravel_unravel_cols,
    spec_device,
    spec_dtype,
    spec_leaves,
    spec_size,
    tree_add,
    tree_scale,
    zeros_like_spec,
)


def cached_program(A, key: tuple, build: Callable):
    """No-op counterpart of the JAX program cache: returns ``build()``."""
    del A, key
    return build()


_FMT_TREE = "tree"  # tree matching the spec, no column axis
_FMT_TREE_COLS = "tree_cols"  # tree with a trailing column axis on every leaf
_FMT_FLAT_VEC = "flat_vec"  # [N] tensor
_FMT_FLAT_MAT = "flat_mat"  # [N, K] tensor
_FMT_NP_VEC = "np_vec"
_FMT_NP_MAT = "np_mat"


class LinearOperator:
    """Base class for matrix-free linear operators between tree spaces.

    Subclasses implement ``_matmat`` (tree with a trailing column axis on
    every leaf -> the same for the output space) and, unless
    ``SELF_ADJOINT``, ``_adjoint``.
    """

    SELF_ADJOINT: bool = False

    # make numpy defer `ndarray @ op` to __rmatmul__
    __array_ufunc__ = None
    __array_priority__ = 100.0

    def __init__(self, in_spec: Any, out_spec: Any | None = None):
        """Store the input/output space specs (trees of ``TensorSpec``)."""
        self._in_spec = in_spec
        self._out_spec = in_spec if out_spec is None else out_spec
        self._in_size = spec_size(self._in_spec)
        self._out_size = spec_size(self._out_spec)
        self._edges: dict = {}

    @property
    def in_spec(self) -> Any:
        """Tree of ``TensorSpec`` describing the input space."""
        return self._in_spec

    @property
    def out_spec(self) -> Any:
        """Tree of ``TensorSpec`` describing the output space."""
        return self._out_spec

    @property
    def shape(self) -> tuple[int, int]:
        """Flat ``(out_dim, in_dim)`` shape."""
        return (self._out_size, self._in_size)

    @property
    def dtype(self) -> torch.dtype:
        """Common dtype of the input-space leaves."""
        return spec_dtype(self._in_spec)

    @property
    def device(self) -> torch.device:
        """Device of the input space."""
        return spec_device(self._in_spec)

    def __repr__(self) -> str:  # noqa: D105
        return f"<{self.shape[0]}x{self.shape[1]} {type(self).__name__}>"

    # ---- core contract ------------------------------------------------ #
    def _matmat(self, M: Any) -> Any:
        """Apply to a tree whose leaves carry a trailing column axis."""
        raise NotImplementedError

    def _adjoint(self) -> "LinearOperator":
        """Return the adjoint operator."""
        raise NotImplementedError(f"{type(self).__name__} does not implement an adjoint.")

    # ---- format handling ---------------------------------------------- #
    def _edge(self, which: str) -> tuple[Callable, Callable]:
        if which not in self._edges:
            spec = self._in_spec if which == "in" else self._out_spec
            self._edges[which] = make_ravel_unravel_cols(spec)
        return self._edges[which]

    @staticmethod
    def _classify(x: Any, spec: Any, size: int) -> str:
        if isinstance(x, (np.ndarray, torch.Tensor)):
            is_np = isinstance(x, np.ndarray)
            if x.ndim == 1 and x.shape[0] == size:
                return _FMT_NP_VEC if is_np else _FMT_FLAT_VEC
            if x.ndim == 2 and x.shape[0] == size:
                return _FMT_NP_MAT if is_np else _FMT_FLAT_MAT
            raise ValueError(f"Flat input must be [{size}] or [{size}, K], got {tuple(x.shape)}.")
        x_leaves, x_def = pytree.tree_flatten(x)
        s_leaves, s_def = pytree.tree_flatten(spec)
        if x_def == s_def and all(isinstance(v, torch.Tensor) for v in x_leaves):
            shapes = [tuple(v.shape) for v in x_leaves]
            if all(s == sp.shape for s, sp in zip(shapes, s_leaves)):
                return _FMT_TREE
            ncols = {s[-1] for s in shapes if len(s) > 0}
            if len(ncols) == 1 and all(
                s[:-1] == sp.shape for s, sp in zip(shapes, s_leaves)
            ):
                return _FMT_TREE_COLS
        raise ValueError(
            "Input does not match the operator's space: expected a tree with "
            f"shapes {pytree.tree_map(lambda s: s.shape, spec)} (optionally with "
            f"a trailing column axis) or a flat [{size}]/[{size}, K] array."
        )

    def _to_cols(self, x: Any, fmt: str) -> Any:
        if fmt == _FMT_TREE:
            return pytree.tree_map(lambda v: v[..., None], x)
        if fmt == _FMT_TREE_COLS:
            return x
        flat = torch.as_tensor(x, dtype=self.dtype, device=self.device)
        if fmt in (_FMT_FLAT_VEC, _FMT_NP_VEC):
            flat = flat[:, None]
        return self._edge("in")[1](flat)

    def _from_cols(self, M: Any, fmt: str) -> Any:
        if fmt == _FMT_TREE:
            return pytree.tree_map(lambda v: v[..., 0], M)
        if fmt == _FMT_TREE_COLS:
            return M
        flat = self._edge("out")[0](M)
        if fmt in (_FMT_NP_VEC, _FMT_NP_MAT):
            if flat.dtype == torch.bfloat16:  # numpy has no bfloat16
                flat = flat.float()
            flat = flat.detach().cpu().numpy()
        return flat[:, 0] if fmt in (_FMT_FLAT_VEC, _FMT_NP_VEC) else flat

    # ---- multiplication ------------------------------------------------ #
    def __matmul__(self, other: Any) -> Any:
        if isinstance(other, LinearOperator):
            if self.shape[1] != other.shape[0]:
                raise ValueError(
                    f"Shape mismatch in operator chain: {self.shape} @ {other.shape}."
                )
            return ChainLinearOperator([self, other])
        fmt = self._classify(other, self._in_spec, self._in_size)
        return self._from_cols(self._matmat(self._to_cols(other, fmt)), fmt)

    def __rmatmul__(self, other: Any) -> Any:
        """``X @ A`` as ``(A^T X^T)^T`` for flat ``[K, N]`` / ``[N]`` inputs."""
        if isinstance(other, (np.ndarray, torch.Tensor)):
            if other.ndim == 1:
                return self.adjoint() @ other
            if other.ndim == 2 and other.shape[1] == self.shape[0]:
                return (self.adjoint() @ other.T).T
        raise ValueError(
            f"Left multiplication expects [K, {self.shape[0]}] or [{self.shape[0]}]."
        )

    # ---- algebra ------------------------------------------------------- #
    def __add__(self, other: "LinearOperator") -> "LinearOperator":
        if not isinstance(other, LinearOperator):
            return NotImplemented
        return SumLinearOperator(self, other)

    def __sub__(self, other: "LinearOperator") -> "LinearOperator":
        if not isinstance(other, LinearOperator):
            return NotImplemented
        return SumLinearOperator(self, ScaledLinearOperator(other, -1.0))

    def __mul__(self, scalar) -> "LinearOperator":
        if isinstance(scalar, (torch.Tensor, np.ndarray)):
            if scalar.ndim:
                raise ValueError(
                    "Operator scaling requires a scalar, got an array of shape "
                    f"{tuple(scalar.shape)}."
                )
            scalar = scalar.item()
        if not isinstance(scalar, (int, float, complex)):
            return NotImplemented
        return ScaledLinearOperator(self, scalar)

    __rmul__ = __mul__

    def __truediv__(self, scalar) -> "LinearOperator":
        return self.__mul__(1.0 / scalar)

    def __neg__(self) -> "LinearOperator":
        return ScaledLinearOperator(self, -1.0)

    def adjoint(self) -> "LinearOperator":
        """Adjoint operator (``self`` when ``SELF_ADJOINT``)."""
        return self if self.SELF_ADJOINT else self._adjoint()

    @property
    def T(self) -> "LinearOperator":
        """Transpose (the adjoint, for real operators)."""
        return self.adjoint()

    # ---- materialization ---------------------------------------------- #
    def todense(self) -> torch.Tensor:
        """Materialize as a dense ``[out_dim, in_dim]`` tensor (small operators)."""
        eye = torch.eye(self.shape[1], dtype=self.dtype, device=self.device)
        return self @ eye

    # ---- counterparts of the JAX package's program caching ------------- #
    def traced(self, ncols: int = 1) -> tuple[Callable, tuple]:
        """``(fn, ())`` with ``fn(M) == self._matmat(M)``; nothing to hoist."""
        del ncols
        return self._matmat, ()

    def invalidate_traced(self) -> None:
        """No-op: an eager operator has no cached program to drop."""


class PytreeLinearOperator(LinearOperator):
    """Operator defined by a linear function on trees.

    The function maps one input tree (no column axis) to one output tree and
    is ``vmap``-ed over the columns. The adjoint is ``adjoint_matvec`` when
    given, otherwise the vector-Jacobian product of the (linear) function.
    """

    def __init__(
        self,
        matvec: Callable[[Any], Any],
        in_spec: Any,
        out_spec: Any | None = None,
        self_adjoint: bool = False,
        adjoint_matvec: Callable[[Any], Any] | None = None,
    ):
        super().__init__(in_spec, out_spec)
        self._matvec_fn = matvec
        self._adjoint_fn = adjoint_matvec
        self.SELF_ADJOINT = self_adjoint

    def _matmat(self, M: Any) -> Any:
        return torch.func.vmap(self._matvec_fn, in_dims=-1, out_dims=-1)(M)

    def _adjoint(self) -> "LinearOperator":
        if self._adjoint_fn is not None:
            return PytreeLinearOperator(
                self._adjoint_fn, self._out_spec, self._in_spec,
                adjoint_matvec=self._matvec_fn,
            )
        _, vjp_fn = torch.func.vjp(self._matvec_fn, zeros_like_spec(self._in_spec))
        return PytreeLinearOperator(
            lambda w: vjp_fn(w)[0], self._out_spec, self._in_spec,
            adjoint_matvec=self._matvec_fn,
        )


def _specs_compatible(a: Any, b: Any) -> bool:
    """Same tree structure and leaf shapes (dtypes may differ)."""
    la, da = pytree.tree_flatten(a)
    lb, db = pytree.tree_flatten(b)
    return da == db and all(x.shape == y.shape for x, y in zip(la, lb))


def _check_same_space(a: Any, b: Any, what: str) -> None:
    """Refuse composing operators over structurally different spaces."""
    if not _specs_compatible(a, b):
        raise ValueError(
            f"{what}: operator spaces differ in tree structure or shapes "
            f"({[s.shape for s in spec_leaves(a)]} vs {[s.shape for s in spec_leaves(b)]})."
        )


class SumLinearOperator(LinearOperator):
    """Lazy sum ``A + B``."""

    def __init__(self, A: LinearOperator, B: LinearOperator):
        if A.shape != B.shape:
            raise ValueError(f"Cannot add operators of shapes {A.shape}, {B.shape}.")
        _check_same_space(A.in_spec, B.in_spec, "A + B (input space)")
        _check_same_space(A.out_spec, B.out_spec, "A + B (output space)")
        super().__init__(A.in_spec, A.out_spec)
        self._A, self._B = A, B
        self.SELF_ADJOINT = A.SELF_ADJOINT and B.SELF_ADJOINT

    def _matmat(self, M: Any) -> Any:
        return tree_add(self._A._matmat(M), self._B._matmat(M))

    def _adjoint(self) -> LinearOperator:
        return SumLinearOperator(self._A.adjoint(), self._B.adjoint())


class ScaledLinearOperator(LinearOperator):
    """Lazy scalar multiple ``c * A``."""

    def __init__(self, A: LinearOperator, scalar):
        super().__init__(A.in_spec, A.out_spec)
        self._A, self._scalar = A, scalar
        self.SELF_ADJOINT = A.SELF_ADJOINT and not isinstance(scalar, complex)

    def _matmat(self, M: Any) -> Any:
        return tree_scale(self._scalar, self._A._matmat(M))

    def _adjoint(self) -> LinearOperator:
        c = self._scalar.conjugate() if isinstance(self._scalar, complex) else self._scalar
        return ScaledLinearOperator(self._A.adjoint(), c)


def _flatten_chain(ops: Sequence[LinearOperator]) -> list[LinearOperator]:
    flat: list[LinearOperator] = []
    for op in ops:
        flat.extend(op.ops if isinstance(op, ChainLinearOperator) else [op])
    return flat


class ChainLinearOperator(LinearOperator):
    """Lazy product ``A_1 @ A_2 @ ... @ A_k``, applied right to left."""

    def __init__(self, ops: Sequence[LinearOperator]):
        ops = _flatten_chain(ops)
        if not ops:
            raise ValueError("Chain requires at least one operator.")
        for left, right in zip(ops[:-1], ops[1:]):
            if left.shape[1] != right.shape[0]:
                raise ValueError(f"Chain shape mismatch: {left.shape} @ {right.shape}.")
            _check_same_space(left.in_spec, right.out_spec, "A @ B (inner space)")
        super().__init__(ops[-1].in_spec, ops[0].out_spec)
        self.ops = list(ops)

    def __len__(self) -> int:  # noqa: D105
        return len(self.ops)

    def __getitem__(self, idx: int) -> LinearOperator:  # noqa: D105
        return self.ops[idx]

    def _matmat(self, M: Any) -> Any:
        for op in reversed(self.ops):
            M = op._matmat(M)
        return M

    def _adjoint(self) -> LinearOperator:
        return ChainLinearOperator([op.adjoint() for op in reversed(self.ops)])
