"""Library utilities: tree flattening and tree arithmetic, column mapping,
the model-function adapter (:mod:`curvlinops_tpu_torch.utils.misc`) and the
device-prefetching data pipeline (:mod:`curvlinops_tpu_torch.utils.prefetch`);
the CUDA kernel build helper is :mod:`curvlinops_tpu_torch.utils.cuda_build`."""

from curvlinops_tpu_torch.utils.flatten import (
    TensorSpec,
    make_ravel_unravel_cols,
    spec_dtype,
    spec_of,
    spec_size,
    ravel_tree,
    tree_add,
    tree_randn_like,
    tree_scale,
    vmap_columns,
    zeros_like_spec,
)
from curvlinops_tpu_torch.utils.misc import as_model_fn
from curvlinops_tpu_torch.utils.prefetch import PrefetchToDevice, prefetch_to_device

__all__ = [
    "TensorSpec",
    "spec_of",
    "spec_size",
    "spec_dtype",
    "zeros_like_spec",
    "make_ravel_unravel_cols",
    "tree_add",
    "tree_scale",
    "tree_randn_like",
    "ravel_tree",
    "vmap_columns",
    "as_model_fn",
    "PrefetchToDevice",
    "prefetch_to_device",
]
