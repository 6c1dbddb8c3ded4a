"""Library utilities: tree flattening and tree arithmetic."""

from curvlinops_tpu_torch.utils.flatten import (
    TensorSpec,
    make_ravel_unravel_cols,
    spec_dtype,
    spec_of,
    spec_size,
    tree_add,
    tree_scale,
    zeros_like_spec,
)

__all__ = [
    "TensorSpec",
    "spec_of",
    "spec_size",
    "spec_dtype",
    "zeros_like_spec",
    "make_ravel_unravel_cols",
    "tree_add",
    "tree_scale",
]
