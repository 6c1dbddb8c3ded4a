"""Device-prefetching data pipeline.

PyTorch counterpart of ``curvlinops_tpu/utils/prefetch.py``.
:class:`PrefetchToDevice` pulls batches from any iterable on a background
thread and issues their host-to-device copies ``size`` batches ahead, so
that the host's work on the next batches and the copies overlap the
device's work on the current one:

- each CPU tensor is pinned and copied with ``to(device, non_blocking=True)``
  on a side CUDA stream, and an event is recorded after the copies;
- the consumer's current stream waits on that event when it takes the
  batch, and ``record_stream`` tells the caching allocator that the
  consumer's stream uses the memory, so it is not reused early;
- on a CPU target the tensors are moved without pinning or streams.

It is not a data loader: batching, shuffling and augmentation stay with the
caller. It preserves order and is freshly re-iterable, so the operators'
determinism probes (two passes compared) see the same batches in the same
order and still catch a non-deterministic source. An exception in the
source reaches the consumer, and a consumer that stops early stops the
producer.

JAX's ``sharding=`` becomes ``device=``: a ``torch.device`` (or string)
places every batch whole on that device (JAX's ``None``, the default
device, is ``"cuda"`` here); a ``DeviceMesh`` places this process's slice of
every batch's leading axis over the mesh's ``"data"`` axis on its device
(:func:`~curvlinops_tpu_torch.parallel.shard_batch`), as a ``NamedSharding``
over the data axis places each device's shard. The curvature operators'
``mesh=`` takes whole batches and slices them itself, so give them batches
placed on a ``torch.device``.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Iterable, Iterator

import numpy as np
import torch
from torch.utils import _pytree as pytree

__all__ = ["PrefetchToDevice", "prefetch_to_device"]

_SENTINEL = object()


class PrefetchToDevice:
    """Wrap a batch iterable: background pull and ahead-of-time copies.

    Args:
        data: Iterable of batch trees (e.g. ``(X, y)`` tuples of tensors or
            numpy arrays). Must be re-iterable if the consumer iterates more
            than once (operators iterate at least twice).
        size: How many batches to keep in flight (host queue depth). Two is
            enough to overlap one batch of host work with device compute.
        device: A ``torch.device`` (or string) to place every batch on, or a
            ``DeviceMesh`` to place this process's slice of it (see the
            module docstring).

    Raises:
        ValueError: If ``size < 1``.

    Example::

        data = PrefetchToDevice(my_batches, size=2, device="cuda")
        GGN = GGNLinearOperator(model, loss_fn, params, data)
    """

    def __init__(self, data: Iterable[Any], size: int = 2, device: Any = "cuda") -> None:
        if size < 1:
            raise ValueError(f"prefetch size must be >= 1, got {size}")
        self._data = data
        self._size = size
        self._shards = None
        if isinstance(device, (str, torch.device)):
            self._device = torch.device(device)
        else:  # a DeviceMesh
            from curvlinops_tpu_torch.parallel.mesh import DataShards, mesh_device

            self._shards = DataShards(device, "data")
            self._device = mesh_device(device)
        if self._device.type == "cuda" and self._device.index is None:
            self._device = torch.device("cuda", torch.cuda.current_device())
        self._stream = None  # the side stream of the copies, made at first use

    def _put(self, batch: Any, stream) -> tuple[Any, Any]:
        """Start the copies of one batch; returns ``(batch, event)``."""
        batch = pytree.tree_map(
            lambda t: torch.from_numpy(t) if isinstance(t, np.ndarray) else t, batch
        )
        if self._shards is not None:
            batch = self._shards.shard(batch)
        if stream is None:
            return pytree.tree_map(
                lambda t: t.to(self._device) if isinstance(t, torch.Tensor) else t, batch
            ), None

        def copy(t):
            if not isinstance(t, torch.Tensor):
                return t
            if t.device.type == "cpu":
                t = t.pin_memory()
            return t.to(self._device, non_blocking=True)

        with torch.cuda.stream(stream):
            out = pytree.tree_map(copy, batch)
            event = torch.cuda.Event()
            event.record(stream)
        return out, event

    def _take(self, batch: Any, event) -> Any:
        """Make the consumer's stream wait for a batch's copies."""
        if event is None:
            return batch
        consumer = torch.cuda.current_stream(self._device)
        consumer.wait_event(event)
        for t in pytree.tree_leaves(batch):
            if isinstance(t, torch.Tensor) and t.device.type == "cuda":
                t.record_stream(consumer)
        return batch

    def __iter__(self) -> Iterator[Any]:
        q: queue.Queue = queue.Queue(maxsize=self._size)
        stop = threading.Event()
        if self._device.type == "cuda" and self._stream is None:
            self._stream = torch.cuda.Stream(self._device)
        stream = self._stream

        def enqueue(item: Any) -> bool:
            """Blocking put that gives up once the consumer is gone."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer() -> None:
            try:
                for batch in self._data:
                    if stop.is_set():
                        return
                    # the copies start on this thread: the host work of
                    # batch i+1..i+size overlaps the consumer's compute on i
                    if not enqueue(self._put(batch, stream)):
                        return
            except BaseException as exc:  # propagate into the consumer
                enqueue((_SENTINEL, exc))
                return
            enqueue((_SENTINEL, None))

        thread = threading.Thread(target=producer, name="PrefetchToDevice", daemon=True)
        thread.start()
        try:
            while True:
                item = q.get()
                if item[0] is _SENTINEL:
                    if item[1] is not None:
                        raise item[1]
                    return
                yield self._take(*item)
        finally:
            # stop the producer if the consumer quits early (e.g. zip()
            # with a shorter iterator) without consuming the whole dataset
            stop.set()
            while thread.is_alive():
                try:
                    q.get_nowait()
                except queue.Empty:
                    pass
                thread.join(timeout=0.1)


def prefetch_to_device(data: Iterable[Any], size: int = 2, device: Any = "cuda") -> PrefetchToDevice:
    """Functional alias for :class:`PrefetchToDevice`."""
    return PrefetchToDevice(data, size=size, device=device)
