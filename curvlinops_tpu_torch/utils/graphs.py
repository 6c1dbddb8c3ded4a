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
- :class:`ChunkedLoop` is the counterpart of a ``lax.while_loop`` program
  (CG, MINRES, LSMR, LOBPCG): a loop that stops on a device test. A CUDA
  graph cannot branch on the host, and the card's torch (2.11) has no
  conditional graph nodes, so the loop is captured as a chunk of
  :data:`CHUNK` masked steps: each step runs, and its result is committed
  (``torch.where``) only while the loop's device flag says it runs. The
  host replays the chunk and reads the flag and the step count once per
  replay, so a solve that stops mid-chunk runs at most ``CHUNK - 1``
  steps whose results are dropped. :class:`EagerLoop` runs the same steps
  with a Python ``if`` on the flag before each one, for operators that
  cannot be captured.
"""

from __future__ import annotations

import time
from typing import Any, Callable

import torch
from torch.utils import _pytree as pytree

_INLINE = [0]  # depth of programs warming up or being captured
# the way out named when a fused operator's product cannot be captured
STREAM_REMEDY = "set `fuse_batches = False` on the operator to stream its batches"
# ... and when a program over other operators' products cannot (a solve, a series)
SOLVER_REMEDY = (
    "such a program captures only operators marked `capturable`; run it eagerly "
    "over an operator that is not (`fuse_batches = False` on a curvature operator)"
)


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
        remedy: The way out that a capture failure names.

    After the capture, ``capture_seconds`` holds the capture's host time
    and ``reserved_bytes`` the device memory reserved just before and just
    after it (``torch.cuda.memory_reserved``).
    """

    def __init__(
        self, fn: Callable, device: torch.device, name: str = "program", pool=None,
        remedy: str = STREAM_REMEDY,
    ):
        self._fn = fn
        self.device = torch.device(device)
        self.name = name
        self._pool = pool
        self._remedy = remedy
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
        """Warm up on a side stream, then capture ``fn`` on it."""
        self._signature = _signature(args)
        self._static_args = _clone(args)
        run = lambda: self._fn(*self._static_args)  # noqa: E731
        self._graph, self._static_out, self.capture_seconds, self.reserved_bytes = capture_graph(
            self.device, self.name, self._pool, self._remedy, run, run
        )


def capture_graph(
    device: torch.device, name: str, pool, remedy: str, warm_up: Callable, body: Callable
) -> tuple:
    """Run ``warm_up()`` on a side stream, then capture ``body()`` on it.

    Programs called inside either run inline. Returns ``(graph, body's
    result, capture seconds, (reserved bytes before, after))``.

    Raises:
        RuntimeError: If the capture fails, naming ``name`` and ``remedy``
            (the warm-up's own errors propagate unchanged).
    """
    with torch.cuda.device(device):
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        graph = torch.cuda.CUDAGraph()
        _INLINE[0] += 1
        try:
            with torch.cuda.stream(stream):
                warm_up()
            torch.cuda.current_stream().wait_stream(stream)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()  # as the capture does: count its pool alone
            before = torch.cuda.memory_reserved(device)
            start = time.perf_counter()
            try:
                with torch.cuda.graph(graph, pool=pool, stream=stream):
                    out = body()
            except Exception as err:
                cause = f" (after: {err.__context__})" if err.__context__ else ""
                raise RuntimeError(
                    f"Capturing {name} as a CUDA graph failed: {err}{cause}. A captured "
                    f"program may not read the host or copy from pageable memory; {remedy}."
                ) from err
            seconds = time.perf_counter() - start
            reserved = (before, torch.cuda.memory_reserved(device))
        finally:
            _INLINE[0] -= 1
    return graph, out, seconds, reserved


# steps in a captured chunk of a loop that stops on a device test: at most
# CHUNK - 1 steps past the stop run, their results dropped; one host read a
# chunk (chosen on the H100, PERF.md)
CHUNK = 4


def _advance(step: Callable, maxiter: int, k, running, state: tuple, consts: tuple) -> tuple:
    """One step of a loop, committed where ``running``: ``(k, running,
    state)`` after it. ``step(k, state, consts)`` returns the next state and
    the device flag "go on"; the loop also stops at ``maxiter`` steps."""
    new, go_on = step(k, state, consts)
    k1 = k + 1
    state = tuple(torch.where(running, n, o) for n, o in zip(new, state))
    return torch.where(running, k1, k), running & go_on & (k1 < maxiter), state


class EagerLoop:
    """``while k < maxiter and running: state = step(k, state)``, eagerly:
    one host read of the flag before each step (:class:`ChunkedLoop`'s
    interface, for operators that cannot be captured and for plain
    callables)."""

    def __init__(self):
        self.iterations: int | None = None
        self.host_reads: int | None = None

    def __call__(self, step: Callable, maxiter: int, state: tuple, consts: tuple, running) -> tuple:
        """Run the loop; returns ``(state, iterations, host reads)``."""
        k = torch.zeros((), dtype=torch.int64, device=running.device)
        iterations = reads = 0
        while iterations < maxiter:
            reads += 1
            if not bool(running):
                break
            state, running = step(k, state, consts)
            k, iterations = k + 1, iterations + 1
        self.iterations, self.host_reads = iterations, reads
        return state, iterations, reads


def record(history: torch.Tensor, k, row: torch.Tensor) -> torch.Tensor:
    """``history`` with ``row`` as its row ``k + 1`` (a device index; a
    masked step past the cap writes the last row, and is dropped)."""
    index = torch.clamp(k + 1, max=history.shape[0] - 1).reshape(1)
    return history.index_copy(0, index, row[None])


class ChunkedLoop:
    """A loop that stops on a device test, replayed in chunks of ``CHUNK``
    masked steps with one host read a chunk.

    Each call runs ``step`` (see :func:`_advance`) from a state until the
    flag ``running`` is false or ``maxiter`` steps ran; the state and the
    loop-invariant ``consts`` are tuples of tensors of fixed shapes and
    dtypes. On the card the first call warms up one step on a side stream
    and captures one chunk as a CUDA graph that reads and writes static
    buffers in place; every call loads its state and constants into them and
    replays the chunk until the flag read after a replay is false. On the
    CPU the same chunk runs eagerly, with the same reads. The step of the
    first call is the one captured: later calls must pass the same step
    (the same products, shapes and ``maxiter``), as the cache key that
    holds the loop ensures. After each call ``iterations`` and
    ``host_reads`` hold its step count and flag reads; after the capture,
    ``capture_seconds`` and ``reserved_bytes`` as on
    :class:`CapturedProgram`.
    """

    def __init__(self, device: torch.device, name: str = "loop", pool=None,
                 remedy: str = SOLVER_REMEDY):
        self.device = torch.device(device)
        self.name = name
        self._pool = pool
        self._remedy = remedy
        self._graph = None
        self._static: tuple | None = None  # (status, state, consts) the graph reads and writes
        self._signature: tuple | None = None
        self.iterations: int | None = None
        self.host_reads: int | None = None
        self.capture_seconds: float | None = None
        self.reserved_bytes: tuple[int, int] | None = None

    @staticmethod
    def _chunk(step: Callable, maxiter: int, status, state: tuple, consts: tuple) -> tuple:
        """``CHUNK`` masked steps from ``status == [running, k]``."""
        running, k = status[0].bool(), status[1]
        for _ in range(CHUNK):
            k, running, state = _advance(step, maxiter, k, running, state, consts)
        return torch.stack([running.long(), k]), state

    def __call__(self, step: Callable, maxiter: int, state: tuple, consts: tuple, running) -> tuple:
        """Run the loop; returns ``(state, iterations, host reads)``."""
        if maxiter <= 0:
            running = torch.zeros_like(running)
        status = torch.stack([running.long(), torch.zeros_like(running, dtype=torch.long)])
        if self.device.type != "cuda" or _INLINE[0] or capturing(self.device):
            replay = None
        else:
            replay = self._load(step, maxiter, status, state, consts)
        reads = 0
        while True:
            if replay is None:
                status, state = self._chunk(step, maxiter, status, state, consts)
            else:
                replay()
            reads += 1
            go_on, k = (status if replay is None else self._static[0]).tolist()
            if not go_on:
                break
        if replay is not None:
            state = _clone(self._static[1])
        self.iterations, self.host_reads = k, reads
        return state, k, reads

    def _load(self, step: Callable, maxiter: int, status, state: tuple, consts: tuple) -> Callable:
        """Copy the call's status, state and constants into the static
        buffers (capturing the chunk on the first call); returns the replay."""
        args = (status, state, consts)
        if self._graph is None:
            self._signature = (_signature(args), maxiter)
            self._static = _clone(args)

            def warm_up():  # one step on copies: the static buffers stay loaded
                s, st, c = _clone(self._static)
                _advance(step, maxiter, s[1], s[0].bool(), st, c)

            def body():
                s, st, c = self._static
                s_new, st_new = self._chunk(step, maxiter, s, st, c)
                s.copy_(s_new)
                for dst, src in zip(st, st_new):
                    dst.copy_(src)

            self._graph, _, self.capture_seconds, self.reserved_bytes = capture_graph(
                self.device, self.name, self._pool, self._remedy, warm_up, body
            )
        elif (_signature(args), maxiter) != self._signature:
            raise ValueError(
                f"{self.name}: state differs in structure, shape, dtype or device, or "
                "maxiter differs, from the captured one."
            )
        for dst, src in zip(pytree.tree_leaves(self._static), pytree.tree_leaves(args)):
            dst.copy_(src)
        return self._graph.replay


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
