"""Eigendecomposition of small symmetric matrices on the device.

The port's own kernel, which replaces no TPU kernel: LOBPCG
(:mod:`curvlinops_tpu_torch.solvers.eigsh`) solves a ``[3k, 3k]``
Rayleigh-Ritz problem and several ``[k, k]`` Gram problems each
iteration, and ``torch.linalg.eigh`` checks its convergence on the host, so
a LOBPCG step that calls it cannot be captured as a CUDA graph. The kernel
(``csrc/small_eigh.cu``: cyclic Jacobi, one thread block per matrix; its
header says what bounds it) reads nothing to the host and launches on the
current stream. It takes ``n <= MAX_N`` by one of two routes
(:func:`kernel_route`): A and its eigenvectors in shared memory with 256
threads up to ``n = SHARED_MAX_N``, else in a device-memory workspace that
the wrapper allocates, with 1024 threads. The switch is where the second
overtook the first on an H100 (``tools/torch_small_eigh_routes.py``): the
shared route's lower latency wins while a round is small, the workspace
route's four times as many threads once it is large. It is CUDA C++ for
``sm_90a``, compiled with ``nvcc`` into a shared library at first use and
called through ``ctypes`` (:mod:`curvlinops_tpu_torch.utils.cuda_build`).

:func:`small_eigh` launches the kernel for a CUDA tensor and raises on
anything it does not take (there is no fallback); for a CPU tensor it
computes :func:`small_eigh_plain` (``torch.linalg.eigh``, flipped to
descending order). It counts its launches in ``small_eigh.launches`` and,
by route, in ``small_eigh.route_launches``.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from curvlinops_tpu_torch.utils import cuda_build

SOURCE = Path(__file__).resolve().parent / "csrc" / "small_eigh.cu"
MAX_N = 512  # the kernel's kMaxN: the rotations' scratch of one block is sized for it
MAX_SWEEPS = 30  # Jacobi sweeps; the kernel stops earlier once the off-diagonal is at eps
# the largest n of the shared route: on an H100 (700 W) one launch's device
# time, shared against workspace, was 0.557 against 0.569 ms at n = 44 and
# 0.686 against 0.666 at 48 (float32), 0.763 against 0.767 at 48 and 1.080
# against 1.062 at 56 (float64) (tools/torch_small_eigh_routes.py)
SHARED_MAX_N = 44


def _bind(lib: ctypes.CDLL) -> None:
    for name in ("small_eigh_f32", "small_eigh_f64"):
        fn = getattr(lib, name)
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 3
                       + [ctypes.c_double, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int


def small_eigh_plain(A: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: ``torch.linalg.eigh`` (the lower triangle),
    eigenvalues descending and their eigenvectors as columns."""
    w, V = torch.linalg.eigh(A)
    return w.flip(-1), V.flip(-1)


def kernel_route(n: int) -> str | None:
    """The kernel's route for ``[n, n]`` matrices: ``"shared"`` up to
    :data:`SHARED_MAX_N`, ``"global"`` up to :data:`MAX_N`, ``None`` past it
    (the kernel does not take them)."""
    if not 1 <= n <= MAX_N:
        return None
    return "shared" if n <= SHARED_MAX_N else "global"


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
    route = kernel_route(n)
    batch = A.shape[:-2]
    A3 = A.reshape(-1, n, n).contiguous()
    w = torch.empty(A3.shape[:-1], dtype=A.dtype, device=A.device)
    V = torch.empty_like(A3)
    if A3.shape[0] == 0:
        return w.reshape(*batch, n), V.reshape(A.shape)
    lib = cuda_build.load(SOURCE, _bind)
    fn = lib.small_eigh_f32 if A.dtype == torch.float32 else lib.small_eigh_f64
    # the global route's A (the input's type) and V^T (float64)
    work = [torch.empty_like(A3), torch.empty(A3.shape, dtype=torch.float64, device=A.device)] \
        if route == "global" else [None, None]
    with torch.cuda.device(A.device):
        err = fn(A3.data_ptr(), w.data_ptr(), V.data_ptr(),
                 *(None if t is None else t.data_ptr() for t in work),
                 None if sweeps is None else sweeps.data_ptr(), A3.shape[0], n, MAX_SWEEPS,
                 torch.finfo(A.dtype).eps, int(route == "global"),
                 torch.cuda.current_stream(A.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"small_eigh kernel launch failed: CUDA error {err}.")
    small_eigh.launches += 1
    small_eigh.route_launches[route] += 1
    return w.reshape(*batch, n), V.reshape(A.shape)


small_eigh.launches = 0
small_eigh.route_launches = {"shared": 0, "global": 0}
