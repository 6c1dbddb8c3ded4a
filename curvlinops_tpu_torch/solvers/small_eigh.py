"""Eigendecomposition of small symmetric matrices on the device.

The port's own kernel, which replaces no TPU kernel: LOBPCG
(:mod:`curvlinops_tpu_torch.solvers.eigsh`) solves a ``[3k, 3k]``
Rayleigh-Ritz problem and several ``[k, k]`` Gram problems each
iteration, and ``torch.linalg.eigh`` checks its convergence on the host, so
a LOBPCG step that calls it cannot be captured as a CUDA graph. The kernel
(``csrc/small_eigh.cu``; its header says what bounds it) reads nothing to
the host and launches on the current stream. It takes ``n <= MAX_N`` by one
of two routes (:func:`kernel_route`): for the sizes in
:data:`SHARED_SIZES` cyclic Jacobi in one block of 256 threads with A and
its eigenvectors in shared memory; for the others blocked Jacobi across a
thread-block cluster of ``ceil(n / 32)`` CTAs (:func:`cluster_shape`), A
and the eigenvectors in a float64 device-memory workspace that the wrapper
allocates. The switches are where one overtook the other on an H100
(``tools/torch_small_eigh_routes.py``). It is CUDA C++ for ``sm_90a``,
compiled with ``nvcc`` into a shared library at first use and called
through ``ctypes`` (:mod:`curvlinops_tpu_torch.utils.cuda_build`).

:func:`small_eigh` launches the kernel for a CUDA tensor and raises on
anything it does not take, a cluster the card cannot place included (there
is no fallback); for a CPU tensor it computes :func:`small_eigh_plain`
(``torch.linalg.eigh``, flipped to descending order). It counts its
launches in ``small_eigh.launches`` and, by size n, in
``small_eigh.size_launches``.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from curvlinops_tpu_torch.utils import cuda_build

SOURCE = Path(__file__).resolve().parent / "csrc" / "small_eigh.cu"
MAX_N = 512  # the kernel's kMaxN: a cluster of 16 CTAs, each a pair of 16-index blocks
BLOCK = 16  # the cluster route's index block: a CTA diagonalises a pair, [32, 32]
MAX_SWEEPS = 30  # Jacobi sweeps; the kernel stops earlier once the off-diagonal is at eps
# the shared route's sizes: where its device time a sweep was below the
# cluster route's on an H100 (700 W), both types, three matrices a size
# (tools/torch_small_eigh_routes.py --both-routes --seeds 3). Float32 ms a
# sweep, shared against cluster: n = 16 0.0126 against 0.0129, 17 0.0153
# against 0.0148; past 32 the cluster route pads n to 64, and the shared
# route wins again to 38 (0.0497 against 0.0572); at 39-40 it loses
# (0.0725 and 0.0597 against 0.0571 and 0.0569), and by more from 41 on
SHARED_SIZES = (range(1, 17), range(33, 39))


def _bind(lib: ctypes.CDLL) -> None:
    for name in ("small_eigh_f32", "small_eigh_f64"):
        fn = getattr(lib, name)
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
                       + [ctypes.c_double, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int


def small_eigh_plain(A: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: ``torch.linalg.eigh`` (the lower triangle),
    eigenvalues descending and their eigenvectors as columns."""
    w, V = torch.linalg.eigh(A)
    return w.flip(-1), V.flip(-1)


def kernel_route(n: int) -> str | None:
    """The kernel's route for ``[n, n]`` matrices: ``"shared"`` for the
    sizes in :data:`SHARED_SIZES`, ``"cluster"`` for the others up to
    :data:`MAX_N`, ``None`` past it (the kernel does not take them)."""
    if not 1 <= n <= MAX_N:
        return None
    return "shared" if any(n in sizes for sizes in SHARED_SIZES) else "cluster"


def cluster_shape(n: int) -> tuple[int, int]:
    """``(CTAs, N)`` of the cluster route for ``[n, n]`` matrices: one CTA a
    pair of index blocks, so ``ceil(n / 32)`` CTAs, and ``n`` padded with
    zero rows and columns to ``N = 32 ceil(n / 32)``."""
    ctas = -(-n // (2 * BLOCK))
    return ctas, 2 * BLOCK * ctas


def small_eigh(
    A: torch.Tensor, sweeps: torch.Tensor | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Eigenvalues (descending) and eigenvectors (columns) of symmetric
    ``[..., n, n]`` matrices, ``n <= 512``, reading their lower triangles,
    by the route :func:`kernel_route` gives.

    ``sweeps``, an int32 tensor on the card with one entry per matrix,
    receives each matrix's Jacobi sweep count (to count the kernel's work);
    the CPU path ignores it.

    Raises:
        ValueError: For a non-square or too large matrix, or a tensor on
            neither the CPU nor a CUDA device.
        TypeError: For a dtype other than float32/float64.
        RuntimeError: If the launch fails or is refused (on the cluster
            route: a cluster the card cannot place, or more than 65,535
            matrices).
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
    route = kernel_route(n)
    batch = A.shape[:-2]
    A3 = A.reshape(-1, n, n).contiguous()
    w = torch.empty(A3.shape[:-1], dtype=A.dtype, device=A.device)
    V = torch.empty_like(A3)
    if A3.shape[0] == 0:
        return w.reshape(*batch, n), V.reshape(A.shape)
    lib = cuda_build.load(SOURCE, _bind)
    fn = lib.small_eigh_f32 if A.dtype == torch.float32 else lib.small_eigh_f64
    # the cluster route's padded A and V^T, float64
    work = None
    if route == "cluster":
        N = cluster_shape(n)[1]
        work = torch.empty((A3.shape[0], 2, N, N), dtype=torch.float64, device=A.device)
    with torch.cuda.device(A.device):
        err = fn(A3.data_ptr(), w.data_ptr(), V.data_ptr(),
                 None if work is None else work.data_ptr(),
                 None if sweeps is None else sweeps.data_ptr(), A3.shape[0], n, MAX_SWEEPS,
                 torch.finfo(A.dtype).eps, int(route == "cluster"),
                 torch.cuda.current_stream(A.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"small_eigh kernel launch failed: CUDA error {err}.")
    small_eigh.launches += 1
    small_eigh.size_launches[n] = small_eigh.size_launches.get(n, 0) + 1
    return w.reshape(*batch, n), V.reshape(A.shape)


small_eigh.launches = 0
small_eigh.size_launches = {}
