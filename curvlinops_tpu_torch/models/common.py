"""Shared model utilities: problem container, initializers, device choice,
and the mapping of parameters between the JAX package and the port."""

from __future__ import annotations

import math
import re
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch
from torch import nn

from curvlinops_tpu_torch.models.stack import StackedLinear


@dataclass
class Problem:
    """A benchmark problem: model, loss, parameters and one data batch.

    The JAX package's functional ``model_fn`` is an ``nn.Module`` here (the
    MLP stays a callable ``(params, X) -> prediction``), and ``kfac_params``
    names the parameters KFAC covers (conv/linear weights and biases with
    all dims <= 50k); the remaining parameters stay in the module.
    """

    name: str
    model: nn.Module | Callable
    loss_fn: Any
    params: dict
    data: list
    kfac_params: dict | None = None


def he_normal(
    shape: tuple, fan_in: int, generator: torch.Generator, dtype=torch.float32
) -> torch.Tensor:
    """He-normal initialization (drawn on the CPU from ``generator``)."""
    return torch.randn(shape, generator=generator, dtype=dtype) * math.sqrt(2.0 / fan_in)


def lecun_normal(
    shape: tuple, fan_in: int, generator: torch.Generator, dtype=torch.float32
) -> torch.Tensor:
    """LeCun-normal initialization (drawn on the CPU from ``generator``)."""
    return torch.randn(shape, generator=generator, dtype=dtype) * math.sqrt(1.0 / fan_in)


def resolve_device(device) -> torch.device:
    """The device a problem is built on; the problems default to ``"cuda"``.

    Raises:
        RuntimeError: If a CUDA device is asked for and none is available
            (there is no fallback to the CPU: pass ``device="cpu"``).
    """
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} asks for a CUDA device, and none is "
            "available; pass device='cpu' to build on the CPU."
        )
    return device


# ---------------------------------------------------------------------- #
# weights and parameter-space vectors across from the JAX package
# ---------------------------------------------------------------------- #
_KEYSTR = re.compile(r"\['([^']*)'\]")
_LEAF_TO_TORCH = {"W": "weight", "b": "bias"}
_LEAF_TO_JAX = {"weight": "W", "bias": "b"}


def _jax_paths(tree: dict, prefix: tuple = ()) -> dict[tuple, Any]:
    """Flatten a nested dict (or a ``keystr``-keyed flat dict) to key paths."""
    out = {}
    for k, v in tree.items():
        path = prefix + (tuple(_KEYSTR.findall(k)) if k.startswith("[") else (k,))
        if isinstance(v, dict):
            out.update(_jax_paths(v, path))
        else:
            out[path] = v
    return out


def _owner(model: nn.Module, name: str) -> nn.Module:
    return model.get_submodule(name.rpartition(".")[0])


def _layout_to_torch(t: torch.Tensor, owner: nn.Module, leaf: str) -> torch.Tensor:
    """One leaf from the JAX layout: conv HWIO -> OIHW (WIO -> OIW), dense ``[in, out]``
    -> ``[out, in]`` (each slice of a stacked ``[L, in, out]``); everything
    else (biases, embedding tables, norm ``scale``/``bias``, CLS token and
    position table) passes unchanged."""
    if leaf == "weight" and isinstance(owner, nn.Conv2d):
        return t.permute(3, 2, 0, 1)
    if leaf == "weight" and isinstance(owner, nn.Conv1d):  # WIO -> OIW
        return t.permute(2, 1, 0)
    if leaf == "weight" and isinstance(owner, (nn.Linear, StackedLinear)):
        return t.transpose(-1, -2)
    return t


def _torch_name(path: tuple, named: dict) -> str:
    """The parameter name of a JAX path: ``W``/``b`` leaves become
    ``weight``/``bias``, and a table leaf (``['wte']``) names the weight of
    its ``nn.Embedding`` module."""
    name = ".".join(path[:-1] + (_LEAF_TO_TORCH.get(path[-1], path[-1]),))
    if name not in named and f"{name}.weight" in named:
        return f"{name}.weight"
    return name


def from_jax_params(params_np: dict, model: nn.Module) -> dict[str, torch.Tensor]:
    """Map a JAX parameter tree of numpy arrays to the model's named tensors.

    Accepts a nested dict (``init_resnet``, ``init_gpt``) or the
    ``keystr``-keyed flat dict of ``kfac_restricted``. ``W``/``b`` leaves of
    convs and dense layers become ``weight``/``bias``, an embedding table
    its module's ``weight``; each leaf is mapped by the module that owns it
    (:func:`_layout_to_torch`), so a scan-stacked ``h`` subtree maps to the
    stacked modules slice by slice. Works for parameter-space vectors too.

    Raises:
        KeyError: For a path the model has no parameter for.
        ValueError: For a shape that does not match the model's.
    """
    named = dict(model.named_parameters())
    out = {}
    for path, arr in _jax_paths(params_np).items():
        name = _torch_name(path, named)
        if name not in named:
            raise KeyError(f"JAX path {path} maps to {name!r}, not a model parameter.")
        leaf = name.rpartition(".")[2]
        t = _layout_to_torch(torch.from_numpy(np.array(arr)), _owner(model, name), leaf)
        ref = named[name]
        if tuple(t.shape) != tuple(ref.shape):
            raise ValueError(f"{name}: shape {tuple(t.shape)} vs model {tuple(ref.shape)}.")
        out[name] = t.contiguous().to(device=ref.device, dtype=ref.dtype)
    return out


def to_jax_params(named: dict[str, torch.Tensor], model: nn.Module) -> dict:
    """Inverse of :func:`from_jax_params`: a nested dict of numpy arrays.

    Each array keeps its tensor's dtype, but bfloat16 (which numpy lacks)
    becomes float32.
    """
    tree: dict = {}
    for name, t in named.items():
        *prefix, leaf = name.split(".")
        owner = _owner(model, name)
        arr = t.detach().cpu()
        if arr.dtype == torch.bfloat16:
            arr = arr.float()
        if leaf == "weight" and isinstance(owner, nn.Conv2d):
            arr = arr.permute(2, 3, 1, 0)
        elif leaf == "weight" and isinstance(owner, (nn.Linear, StackedLinear)):
            arr = arr.transpose(-1, -2)
        if isinstance(owner, nn.Embedding):
            leaf = prefix.pop()  # the table is a leaf of its own in JAX
        elif isinstance(owner, (nn.Conv2d, nn.Linear, StackedLinear)):
            leaf = _LEAF_TO_JAX[leaf]
        node = tree
        for k in prefix:
            node = node.setdefault(k, {})
        node[leaf] = arr.contiguous().numpy()
    return tree
