"""Tree <-> flat-vector conversion helpers.

PyTorch counterpart of ``curvlinops_tpu/utils/flatten.py``. Operators map
trees of tensors (a dict of named parameters, or a tuple of canonical
blocks) to trees; flat ``[N]`` / ``[N, K]`` tensors are accepted at the edge.
A space is described by a tree of :class:`TensorSpec` leaves, the
counterpart of ``jax.ShapeDtypeStruct``. Flat order is the tree's leaf order
(insertion order for dicts).

``vmap_columns`` maps a per-vector function over a trailing column axis,
and ``tree_randn_like`` draws a probe vector from an explicit
``torch.Generator`` (the JAX package threads ``jax.random`` keys).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable

import torch
from torch.utils import _pytree as pytree


@dataclass(frozen=True)
class TensorSpec:
    """Shape, dtype and device of one tensor in a space."""

    shape: tuple
    dtype: torch.dtype
    device: torch.device


def spec_of(tree: Any) -> Any:
    """Tree of :class:`TensorSpec` describing ``tree``."""
    return pytree.tree_map(
        lambda x: TensorSpec(tuple(x.shape), x.dtype, x.device), tree
    )


def spec_leaves(spec: Any) -> list[TensorSpec]:
    """The :class:`TensorSpec` leaves of a spec tree."""
    return pytree.tree_leaves(spec)


def spec_size(spec: Any) -> int:
    """Total number of scalar entries described by a spec tree."""
    return sum(math.prod(s.shape) for s in spec_leaves(spec))


def spec_dtype(spec: Any) -> torch.dtype:
    """Common dtype of the spec's leaves (type promotion)."""
    leaves = spec_leaves(spec)
    if not leaves:
        raise ValueError("Empty spec has no dtype.")
    dtype = leaves[0].dtype
    for s in leaves[1:]:
        dtype = torch.promote_types(dtype, s.dtype)
    return dtype


def spec_device(spec: Any) -> torch.device:
    """Device of the spec's first leaf."""
    return spec_leaves(spec)[0].device


def zeros_like_spec(spec: Any) -> Any:
    """Materialize a tree of zeros matching a spec."""
    return pytree.tree_map(
        lambda s: torch.zeros(s.shape, dtype=s.dtype, device=s.device), spec
    )


def make_ravel_unravel_cols(spec: Any) -> tuple[Callable, Callable]:
    """Build ``(ravel_cols, unravel_cols)`` between a spec and ``[N, K]`` matrices.

    ``unravel_cols(mat[N, K])`` returns a tree whose leaves carry a trailing
    column axis ``K``; ``ravel_cols`` is its inverse.
    """
    leaves, treedef = pytree.tree_flatten(spec)
    shapes = [s.shape for s in leaves]
    sizes = [math.prod(s) for s in shapes]

    def ravel_cols(tree: Any) -> torch.Tensor:
        parts = pytree.tree_leaves(tree)
        K = parts[0].shape[-1]
        return torch.cat([p.reshape(-1, K) for p in parts], dim=0)

    def unravel_cols(mat: torch.Tensor) -> Any:
        K = mat.shape[-1]
        parts = torch.split(mat, sizes, dim=0)
        return pytree.tree_unflatten(
            [p.reshape(*shape, K) for p, shape in zip(parts, shapes)], treedef
        )

    return ravel_cols, unravel_cols


def tree_add(a: Any, b: Any) -> Any:
    """Leafwise sum of two trees."""
    return pytree.tree_map(torch.add, a, b)


def tree_scale(c, tree: Any) -> Any:
    """Scale every leaf of a tree by a scalar."""
    return pytree.tree_map(lambda x: c * x, tree)


def ravel_tree(tree: Any) -> tuple[torch.Tensor, Callable[[torch.Tensor], Any]]:
    """``(flat, unravel)``: the tree's leaves concatenated in leaf order, and
    the map from a flat ``[N]`` tensor back to a tree of the same shapes."""
    leaves, treedef = pytree.tree_flatten(tree)
    shapes = [tuple(t.shape) for t in leaves]
    sizes = [math.prod(s) for s in shapes]
    flat = torch.cat([t.reshape(-1) for t in leaves])

    def unravel(vec: torch.Tensor) -> Any:
        parts = torch.split(vec, sizes)
        return pytree.tree_unflatten(
            [p.reshape(s) for p, s in zip(parts, shapes)], treedef
        )

    return flat, unravel


def vmap_columns(fn: Callable, M: Any, max_columns: int | None = None) -> Any:
    """Map ``fn`` (one vector tree -> one tree) over the trailing column axis.

    ``torch.func.vmap`` over K columns multiplies the residual memory of a
    curvature-vector product by K; ``max_columns`` bounds the columns mapped
    at once (chunks of at most that many, concatenated).
    """
    K = pytree.tree_leaves(M)[0].shape[-1]
    # out_dims=0, then the columns moved last: torch's vmap fails to expand
    # an output that does not depend on the columns (the zero gradient of a
    # parameter an untaken cond branch holds) to a trailing batch axis
    mapped = torch.func.vmap(fn, in_dims=-1, out_dims=0)

    def batched(cols):
        return pytree.tree_map(lambda t: t.movedim(0, -1), mapped(cols))

    if max_columns is None or K <= max_columns:
        return batched(M)
    outs = [
        batched(pytree.tree_map(lambda leaf: leaf[..., start:start + max_columns], M))
        for start in range(0, K, max_columns)
    ]
    return pytree.tree_map(lambda *parts: torch.cat(parts, dim=-1), *outs)


def tree_randn_like(generator: torch.Generator, spec: Any, scale: float = 1.0) -> Any:
    """Standard-normal tree matching a spec, drawn from ``generator`` on the
    generator's device and moved to each leaf's device."""
    return pytree.tree_map(
        lambda s: (scale * torch.randn(
            s.shape, generator=generator, dtype=s.dtype, device=generator.device
        )).to(s.device),
        spec,
    )
