"""Device meshes for data-parallel curvature over ``torch.distributed``.

PyTorch counterpart of ``curvlinops_tpu/parallel/mesh.py``. The JAX package
runs one controller over every device: ``shard_batch`` places a batch over
the mesh's data axis and GSPMD partitions each jitted per-batch program,
inserting the ``psum``s itself. PyTorch's idiom is one process per device
with explicit collectives, so here:

- every process builds the same operator from the same full batches,
  parameters and vectors, as a JAX caller does, and computes on its own
  contiguous slice of every batch's leading axis (:class:`DataShards`);
- the operators reduce with the mesh axis's process group: one
  ``all_reduce(SUM)`` per product after the batch loop, ``all_gather`` for
  sharded stacks and the Jacobian's output rows;
- every result comes back replicated on every process and equals the
  mesh-less result up to the order of the sums.

A mesh is a :class:`torch.distributed.device_mesh.DeviceMesh` with the JAX
axis names (``"data"``, and ``"model"`` for :func:`shard_params`). Its
device type defaults to ``"cuda"`` (NCCL, ``cuda:{local_rank}``); the CPU
with gloo is used only when asked for (``device_type="cpu"``). Nothing falls
back: without a GPU a CUDA mesh raises, and so does a process group whose
backend does not serve the device type.

Deliberate differences from the JAX package:

- ``make_mesh(n)`` needs ``n`` (or the product of ``shape``) to equal the
  world size, where JAX takes the first ``n`` devices of its controller;
- :func:`shard_params` places ``DTensor``s by JAX's heuristic, but the
  operators gather them (``full_tensor()``) when they are built: the
  placement saves no memory inside the operators.
"""

from __future__ import annotations

import math
import operator
import os
from dataclasses import dataclass
from typing import Any, Callable, Iterable, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.utils import _pytree as pytree

_BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def _init_default_group(device_type: str) -> None:
    """Initialise the default process group for ``device_type``.

    Under ``torchrun`` (``RANK`` and ``WORLD_SIZE`` in the environment) it
    reads ``env://``; a process on its own gets a one-process group on an
    in-memory store, so that ``make_mesh()`` works without a launcher.
    """
    backend = _BACKENDS[device_type]
    if device_type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, init_method="env://")
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)


def make_mesh(
    n_devices: int | None = None,
    axis_names: Sequence[str] = ("data",),
    shape: Sequence[int] | None = None,
    device_type: str = "cuda",
) -> DeviceMesh:
    """Build a mesh over every process of the default process group.

    Without an initialised process group, the group is initialised here:
    from ``env://`` under ``torchrun --nproc_per_node=N``, else as a
    one-process group (world size 1). A CUDA mesh sets each process's
    device to ``cuda:{LOCAL_RANK}``.

    Args:
        n_devices: Number of devices; must equal the world size (all
            processes if ``None``).
        axis_names: Mesh axis names; default is a 1-D data axis.
        shape: Per-axis sizes; default puts every process on the first axis.
        device_type: ``"cuda"`` (NCCL) or ``"cpu"`` (gloo).

    Returns:
        A ``DeviceMesh`` with ``mesh_dim_names=axis_names``.

    Raises:
        TypeError: If ``n_devices`` is not int-like (axis names passed
            positionally).
        ValueError: If ``n_devices`` or ``shape`` does not cover the world
            size exactly, or for an unknown ``device_type``.
        RuntimeError: For a CUDA mesh without a GPU, or a process group
            whose backend does not serve ``device_type``.
    """
    if n_devices is not None:
        try:  # accept anything int-like (numpy integers, 0-d arrays)
            n_devices = operator.index(n_devices)
        except TypeError:
            raise TypeError(
                "make_mesh's first argument is n_devices (an int); pass "
                f"axis names as axis_names=... (got {n_devices!r})"
            ) from None
    if device_type not in _BACKENDS:
        raise ValueError(f"device_type must be 'cuda' or 'cpu', got {device_type!r}.")
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "make_mesh(device_type='cuda') needs a GPU; pass device_type='cpu' "
            "for a gloo mesh on the CPU."
        )
    if not dist.is_initialized():
        _init_default_group(device_type)
    backend = str(dist.get_backend())
    if _BACKENDS[device_type] not in backend:
        raise RuntimeError(
            f"The process group's backend {backend!r} does not serve a "
            f"{device_type!r} mesh (needs {_BACKENDS[device_type]!r})."
        )
    world = dist.get_world_size()
    n = world if n_devices is None else n_devices
    if n != world:
        raise ValueError(
            f"make_mesh({n}) on a world of {world} processes: one process drives "
            "one device, so the mesh covers the world size exactly."
        )
    axis_names = tuple(axis_names)
    if shape is None:
        shape = (n,) + (1,) * (len(axis_names) - 1)
    shape = tuple(int(s) for s in shape)
    if math.prod(shape) != world or len(shape) != len(axis_names):
        raise ValueError(
            f"Mesh shape {shape} with axes {axis_names} must have one size per "
            f"axis and cover the world size {world}."
        )
    return DeviceMesh(device_type, torch.arange(world).reshape(shape), mesh_dim_names=axis_names)


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """This process's device of ``mesh``."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _axis_dim(mesh: DeviceMesh, axis: str) -> int:
    names = getattr(mesh, "mesh_dim_names", None) or ()
    if axis not in names:
        raise ValueError(f"Mesh has no axis {axis!r} (axes: {names}).")
    return names.index(axis)


def _rows(leaf: Any, index: int, count: int) -> Any:
    """Slice ``index`` of ``count`` equal contiguous slices of a leading axis.

    Raises:
        ValueError: If the leading dimension does not divide by ``count``.
    """
    if not isinstance(leaf, torch.Tensor) or leaf.ndim == 0:
        return leaf
    n = leaf.shape[0]
    if n % count:
        raise ValueError(
            f"A batch's leading dimension {n} does not divide over the {count} "
            "processes of the mesh's data axis; use batch sizes divisible by it."
        )
    step = n // count
    return leaf[index * step:(index + 1) * step]


def replicate(tree: Any, mesh: DeviceMesh) -> Any:
    """Every tensor of a tree on this process's device, broadcast from the
    mesh's first process, so that every process holds the same values.

    The mesh must span the default process group (as :func:`make_mesh`'s
    meshes do)."""
    device, src = mesh_device(mesh), int(mesh.mesh.flatten()[0])

    def put(leaf):
        if not isinstance(leaf, torch.Tensor):
            return leaf
        out = leaf.detach().to(device).clone()
        dist.broadcast(out, src=src)
        return out

    return pytree.tree_map(put, tree)


def shard_batch(tree: Any, mesh: DeviceMesh, axis: str = "data") -> Any:
    """This process's contiguous slice of every tensor's leading (batch)
    dimension over a mesh axis, on its device (0-d tensors whole).

    Raises:
        ValueError: If a leading dimension does not divide by the axis size.
    """
    shards = DataShards(mesh, axis)
    return shards.shard(tree, mesh_device(mesh))


def shard_params(
    tree: Any,
    mesh: DeviceMesh,
    axis: str = "model",
    min_size: int = 1024,
    report: dict | None = None,
    verbose: bool = False,
) -> Any:
    """Shard large parameter matrices over a model axis (tensor-parallel style).

    For each 2D+ leaf the LARGEST dimension that is divisible by the axis
    size and at least ``min_size`` is sharded (the trailing dim wins ties);
    leaves with no eligible dimension are replicated. The result is a tree
    of ``DTensor``s. The curvature operators gather them with
    ``full_tensor()`` when they are built, so the placement saves no memory
    inside them (JAX's GSPMD keeps them sharded through its programs).

    Args:
        tree: Parameter tree.
        mesh: Device mesh.
        axis: Mesh axis to shard over.
        min_size: Minimum dimension size to shard.
        report: Optional dict, filled with ``{"sharded": [(path, shape,
            dim)], "replicated": [(path, shape, reason)]}``; paths are
            ``keystr`` strings such as ``"['big']"``.
        verbose: Print a one-line summary of the placement.

    Returns:
        The placed tree.
    """
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    mesh_dim = _axis_dim(mesh, axis)
    axis_size = mesh.size(mesh_dim)
    device = mesh_device(mesh)
    sharded: list = []
    replicated: list = []

    def place(path, leaf):
        shape = tuple(leaf.shape)
        name = pytree.keystr(path)
        placements = [Replicate()] * mesh.ndim
        if len(shape) < 2:
            replicated.append((name, shape, "fewer than 2 dims"))
        else:
            eligible = [d for d, s in enumerate(shape) if s % axis_size == 0 and s >= min_size]
            if not eligible:
                replicated.append(
                    (name, shape, f"no dim divisible by {axis_size} and >= min_size={min_size}")
                )
            else:
                # largest dim; trailing wins ties (reversed scan order)
                dim = max(reversed(eligible), key=lambda d: shape[d])
                sharded.append((name, shape, dim))
                placements[mesh_dim] = Shard(dim)
        return distribute_tensor(leaf.detach().to(device), mesh, placements)

    out = pytree.tree_map_with_path(place, tree)
    if report is not None:
        report["sharded"] = sharded
        report["replicated"] = replicated
    if verbose:
        n_sh = sum(math.prod(s) for _, s, _ in sharded)
        n_rep = sum(math.prod(s) for _, s, _ in replicated)
        print(
            f"shard_params: {len(sharded)} leaves sharded over '{axis}' "
            f"({n_sh:,} params), {len(replicated)} replicated "
            f"({n_rep:,} params)"
        )
        for name, shape, reason in replicated:
            if math.prod(shape) >= min_size:
                print(f"  replicated {name} {shape}: {reason}")
    return out


def gather_params(tree: Any) -> Any:
    """Every ``DTensor`` of a tree gathered whole (``full_tensor()``)."""
    from torch.distributed.tensor import DTensor

    return pytree.tree_map(lambda t: t.full_tensor() if isinstance(t, DTensor) else t, tree)


@dataclass(frozen=True)
class ShardedGenerator:
    """A batch's generator seen by process ``index`` of ``count`` that split
    the batch into equal contiguous slices: draws are made for the whole
    batch and the process keeps its slice, so no sample depends on the mesh
    (:func:`curvlinops_tpu_torch.curvature.loss_hessian.sample_grad_outputs`)."""

    generator: torch.Generator
    index: int
    count: int


class DataShards:
    """This process's part of a computation split over a mesh's data axis.

    Holds the axis's process group, this process's index on it and the
    axis size, and does the few things an operator needs: slice a batch,
    sum a tree over the axis, gather rows, and map a function over the
    process's part of a stack. Without a mesh (``mesh=None``) the process
    holds the whole computation and each of these is the identity, so an
    operator runs one code path with a mesh and without one.

    Raises:
        ValueError: If the mesh has no axis ``axis``.
    """

    def __init__(self, mesh: DeviceMesh | None, axis: str = "data"):
        self.mesh, self.axis = mesh, axis
        self.group, self.index, self.count = None, 0, 1
        if mesh is not None:
            dim = _axis_dim(mesh, axis)
            self.group = mesh.get_group(dim)
            self.index = mesh.get_local_rank(dim)
            self.count = mesh.size(dim)

    def shard(self, tree: Any, device: torch.device | None = None) -> Any:
        """This process's slice of every tensor's leading axis, moved to
        ``device`` if one is given (the tree itself without a mesh).

        Raises:
            ValueError: If a leading dimension does not divide by the axis size.
        """
        if self.mesh is None:
            return tree
        return pytree.tree_map(
            lambda t: _rows(t, self.index, self.count).to(device or t.device)
            if isinstance(t, torch.Tensor) else t,
            tree,
        )

    def generator(self, gen: torch.Generator | None) -> torch.Generator | ShardedGenerator | None:
        """``gen`` as this process's view of a batch's draws."""
        if gen is None or self.mesh is None:
            return gen
        return ShardedGenerator(gen, self.index, self.count)

    def batches(self, data: Iterable, device: torch.device | None = None,
                generator: Callable[[int], torch.Generator] | None = None):
        """Yield ``(X, y, Xs, ys, gen)`` per batch ``(X, y)`` of ``data``:
        the whole batch, this process's slice of it (:meth:`shard`) and the
        batch's generator ``generator(index)`` seen through the slice
        (:meth:`generator`; ``None`` without ``generator``)."""
        for idx, (X, y) in enumerate(data):
            gen = None if generator is None else self.generator(generator(idx))
            Xs, ys = self.shard((X, y), device)
            yield X, y, Xs, ys, gen

    def all_reduce(self, tree: Any) -> Any:
        """The sum over the axis of every tensor of a tree: one
        ``all_reduce`` per dtype over the leaves packed into one buffer."""
        if self.mesh is None:
            return tree
        leaves, spec = pytree.tree_flatten(tree)
        by_dtype: dict = {}
        for i, t in enumerate(leaves):
            if isinstance(t, torch.Tensor):
                by_dtype.setdefault(t.dtype, []).append(i)
        out = list(leaves)
        for idx in by_dtype.values():
            flat = torch.cat([leaves[i].reshape(-1) for i in idx])
            dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=self.group)
            for i, part in zip(idx, flat.split([leaves[i].numel() for i in idx])):
                out[i] = part.view(leaves[i].shape)
        return pytree.tree_unflatten(out, spec)

    def gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """Every process's ``t`` concatenated along the leading axis, in
        axis order."""
        if self.mesh is None:
            return t
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.count)]
        dist.all_gather(parts, t, group=self.group)
        return torch.cat(parts)

    def any(self, flag: bool) -> bool:
        """Whether ``flag`` holds on any process of the axis, so that every
        process takes the same branch."""
        if self.mesh is None:
            return flag
        t = torch.tensor([int(flag)], device=mesh_device(self.mesh))
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.group)
        return bool(t.item())

    def map_stack(self, fn: Callable, stacks: tuple, pads: tuple) -> tuple:
        """``fn`` on this process's contiguous chunk of stacks that share a
        leading axis ``n``, the results gathered to every process.

        The stacks are padded to a multiple of the axis size with
        ``pads[i]`` (one ``[1, ...]`` slot each); the padded results are
        dropped.

        Returns:
            ``fn``'s outputs (a tuple of ``[n, ...]`` tensors).
        """
        if self.mesh is None:
            return fn(*stacks)
        n = stacks[0].shape[0]
        extra = (-n) % self.count
        if extra:
            stacks = tuple(
                torch.cat([s, p.expand(extra, *p.shape[1:]).to(s)]) for s, p in zip(stacks, pads)
            )
        step = (n + extra) // self.count
        chunk = slice(self.index * step, (self.index + 1) * step)
        outs = fn(*(s[chunk] for s in stacks))
        return tuple(self.gather_rows(o)[:n] for o in outs)
