"""Eigendecomposition of small symmetric matrices on the device.

The port's own kernel, which replaces no TPU kernel: LOBPCG
(:mod:`curvlinops_tpu_torch.solvers.eigsh`) solves a ``[3k, 3k]``
Rayleigh-Ritz problem and several ``[k, k]`` Gram problems each
iteration, and ``torch.linalg.eigh`` checks its convergence on the host, so
a LOBPCG step that calls it cannot be captured as a CUDA graph. The kernel
(``csrc/small_eigh.cu``: cyclic Jacobi in shared memory, one thread block
per matrix; its header says what bounds it) reads nothing to the host and
launches on the current stream. It is CUDA C++ for ``sm_90a``, compiled
with ``nvcc`` into a shared library at first use and called through
``ctypes`` (:mod:`curvlinops_tpu_torch.utils.cuda_build`).

:func:`small_eigh` launches the kernel for a CUDA tensor and raises on
anything it does not take; for a CPU tensor it computes
:func:`small_eigh_plain` (``torch.linalg.eigh``, flipped to descending
order). It counts its launches in ``small_eigh.launches``.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from curvlinops_tpu_torch.utils import cuda_build

SOURCE = Path(__file__).resolve().parent / "csrc" / "small_eigh.cu"
MAX_N = 96  # the kernel holds A and V in shared memory: 147 KB in float64
MAX_SWEEPS = 30  # Jacobi sweeps; the kernel stops earlier once the off-diagonal is at eps


def _bind(lib: ctypes.CDLL) -> None:
    for name, scalar in (("small_eigh_f32", ctypes.c_float), ("small_eigh_f64", ctypes.c_double)):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [scalar, ctypes.c_void_p]
        fn.restype = ctypes.c_int


def small_eigh_plain(A: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: ``torch.linalg.eigh`` (the lower triangle),
    eigenvalues descending and their eigenvectors as columns."""
    w, V = torch.linalg.eigh(A)
    return w.flip(-1), V.flip(-1)


def small_eigh(
    A: torch.Tensor, sweeps: torch.Tensor | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Eigenvalues (descending) and eigenvectors (columns) of symmetric
    ``[..., n, n]`` matrices, ``n <= 96``, reading their lower triangles.

    ``sweeps``, an int32 tensor on the card with one entry per matrix,
    receives each matrix's Jacobi sweep count (to count the kernel's work);
    the CPU path ignores it.

    Raises:
        ValueError: For a non-square or too large matrix, or a tensor on
            neither the CPU nor a CUDA device.
        TypeError: For a dtype other than float32/float64.
        RuntimeError: If the launch fails.
    """
    if A.device.type == "cpu":
        return small_eigh_plain(A)
    if A.device.type != "cuda":
        raise ValueError(f"Unsupported device {A.device}.")
    if A.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"Kernel takes float32 or float64, got {A.dtype}.")
    n = A.shape[-1]
    if A.ndim < 2 or A.shape[-2] != n or not 1 <= n <= MAX_N:
        raise ValueError(f"Kernel takes square matrices of size 1 to {MAX_N}, got {tuple(A.shape)}.")
    batch = A.shape[:-2]
    A3 = A.reshape(-1, n, n).contiguous()
    w = torch.empty(A3.shape[:-1], dtype=A.dtype, device=A.device)
    V = torch.empty_like(A3)
    if A3.shape[0] == 0:
        return w.reshape(*batch, n), V.reshape(A.shape)
    lib = cuda_build.load(SOURCE, _bind)
    fn = lib.small_eigh_f32 if A.dtype == torch.float32 else lib.small_eigh_f64
    with torch.cuda.device(A.device):
        err = fn(A3.data_ptr(), w.data_ptr(), V.data_ptr(),
                 None if sweeps is None else sweeps.data_ptr(), A3.shape[0], n, MAX_SWEEPS,
                 torch.finfo(A.dtype).eps, torch.cuda.current_stream(A.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"small_eigh kernel launch failed: CUDA error {err}.")
    small_eigh.launches += 1
    return w.reshape(*batch, n), V.reshape(A.shape)


small_eigh.launches = 0
