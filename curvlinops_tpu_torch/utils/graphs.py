"""Captured programs: CUDA graphs as the port's counterpart of ``jax.jit``.

The JAX package runs its loops (a multi-batch matmat, a Neumann series, a
Lanczos recurrence) as compiled XLA programs. Their PyTorch counterpart is
a CUDA graph: the loop runs once while the stream is captured, and every
later call replays all of its kernels with one launch and no Python in
between.

- :class:`CapturedProgram` wraps a function of tensors whose shapes and
  dtypes are fixed. On its first call on the card it runs the function
  once on a side stream (lazy initialisation, cuBLAS workspaces, cuDNN's
  choice of algorithms), then captures it into a ``torch.cuda.CUDAGraph``.
  Each call copies its inputs into the graph's static buffers, replays the
  graph and returns clones of the static outputs, so that a result kept
  across two calls is not overwritten.
- A program called while its stream is being captured, or while another
  program warms up, runs its function inline: a Neumann series over a
  fused GGN captures the GGN's loop inside its own graph.
- On CPU tensors the function runs eagerly: the caller asked for the CPU.
- On the card a capture that fails raises, with its reason. Nothing falls
  back to eager execution.
- :class:`DrawTape` holds a batch's random draws. They are made once, from
  the batch's generator, on the first run, and read back on every later
  run and replay, so a captured Monte-Carlo product draws the samples of
  the streamed one, every time, and a program that captures several
  products (a Neumann series over an MC GGN) replays one sample in each.
  Its tensors are read, never written.
"""

from __future__ import annotations

import time
from typing import Any, Callable

import torch
from torch.utils import _pytree as pytree

_INLINE = [0]  # depth of programs warming up or being captured


def capturing(device: torch.device) -> bool:
    """Whether ``device``'s current stream is being captured."""
    return device.type == "cuda" and torch.cuda.is_current_stream_capturing()


def _clone(tree: Any) -> Any:
    return pytree.tree_map(lambda t: t.clone() if isinstance(t, torch.Tensor) else t, tree)


def _signature(tree: Any) -> tuple:
    leaves, spec = pytree.tree_flatten(tree)
    return spec, tuple(
        (tuple(t.shape), t.dtype, t.device) if isinstance(t, torch.Tensor) else t for t in leaves
    )


class CapturedProgram:
    """A function of fixed-shape tensors, replayed as one CUDA graph.

    Args:
        fn: The function; its arguments and result are trees of tensors.
            It must not read the host (``.item()``, ``bool(tensor)``) or copy
            from pageable host memory.
        device: Where it runs. On a CPU device every call runs ``fn``.
        name: Names the program in a capture failure.
        pool: A memory-pool handle (``torch.cuda.graph_pool_handle()``)
            shared with other programs that replay one at a time (their
            outputs are cloned before another replays), or ``None`` for a
            private pool.

    After the capture, ``capture_seconds`` holds the capture's host time
    and ``reserved_bytes`` the device memory reserved just before and just
    after it (``torch.cuda.memory_reserved``).
    """

    def __init__(self, fn: Callable, device: torch.device, name: str = "program", pool=None):
        self._fn = fn
        self.device = torch.device(device)
        self.name = name
        self._pool = pool
        self._graph = None
        self._static_args: Any = None
        self._static_out: Any = None
        self._signature: tuple | None = None
        self.capture_seconds: float | None = None
        self.reserved_bytes: tuple[int, int] | None = None

    def __call__(self, *args: Any) -> Any:
        if self.device.type != "cuda" or _INLINE[0] or capturing(self.device):
            return self._fn(*args)
        if self._graph is None:
            self._capture(args)
        else:
            self._load(args)
        self._graph.replay()
        return _clone(self._static_out)

    def _load(self, args: tuple) -> None:
        if _signature(args) != self._signature:
            raise ValueError(
                f"{self.name}: arguments differ in structure, shape, dtype or device "
                "from the captured ones."
            )
        for dst, src in zip(pytree.tree_leaves(self._static_args), pytree.tree_leaves(args)):
            if isinstance(dst, torch.Tensor):
                dst.copy_(src)

    def _capture(self, args: tuple) -> None:
        """Warm up on a side stream, then capture ``fn`` on it.

        Raises:
            RuntimeError: If the capture fails (the warm-up's own errors
                propagate unchanged).
        """
        with torch.cuda.device(self.device):
            self._signature = _signature(args)
            self._static_args = _clone(args)
            stream = torch.cuda.Stream()
            stream.wait_stream(torch.cuda.current_stream())
            graph = torch.cuda.CUDAGraph()
            _INLINE[0] += 1
            try:
                with torch.cuda.stream(stream):
                    self._fn(*self._static_args)
                torch.cuda.current_stream().wait_stream(stream)
                torch.cuda.synchronize()
                torch.cuda.empty_cache()  # as the capture does: count its pool alone
                before = torch.cuda.memory_reserved(self.device)
                start = time.perf_counter()
                try:
                    with torch.cuda.graph(graph, pool=self._pool, stream=stream):
                        out = self._fn(*self._static_args)
                except Exception as err:
                    cause = f" (after: {err.__context__})" if err.__context__ else ""
                    raise RuntimeError(
                        f"Capturing {self.name} as a CUDA graph failed: {err}{cause}. A captured "
                        "program may not read the host or copy from pageable memory; "
                        "set `fuse_batches = False` on the operator to stream its batches."
                    ) from err
                self.capture_seconds = time.perf_counter() - start
                self.reserved_bytes = (before, torch.cuda.memory_reserved(self.device))
            finally:
                _INLINE[0] -= 1
        self._graph, self._static_out = graph, out


class DrawTape:
    """A batch's random draws: made once from ``generator``, then replayed.

    :func:`~curvlinops_tpu_torch.curvature.loss_hessian.sample_grad_outputs`
    asks for its samples in a fixed order; the first run records each one
    (made from ``generator``, a ``torch.Generator`` or a
    :class:`~curvlinops_tpu_torch.parallel.mesh.ShardedGenerator`), and every
    run after :meth:`rewind` gets the same tensors back. A fresh generator
    per batch makes the same draws, so a taped product equals a streamed one.
    A sample is the draw's outcome, as small as it comes: a cross-entropy
    batch records its sampled class indices, not its exponential race.
    """

    def __init__(self, generator):
        self.generator = generator
        self._draws: list[torch.Tensor] = []
        self._cursor = 0

    def rewind(self) -> None:
        """Start the next run at the first draw."""
        self._cursor = 0

    @property
    def nbytes(self) -> int:
        """Device memory the recorded samples hold."""
        return sum(t.numel() * t.element_size() for t in self._draws)

    def draw(self, make: Callable[[Any], torch.Tensor], shape: tuple) -> torch.Tensor:
        """The next draw, ``make(generator)`` on the first run.

        Raises:
            RuntimeError: If a replayed draw has another shape.
        """
        if self._cursor == len(self._draws):
            self._draws.append(make(self.generator))
        draw = self._draws[self._cursor]
        if tuple(draw.shape) != tuple(shape):
            raise RuntimeError(f"DrawTape: draw of shape {tuple(shape)}, recorded {tuple(draw.shape)}.")
        self._cursor += 1
        return draw
