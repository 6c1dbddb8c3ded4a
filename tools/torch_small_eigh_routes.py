"""Time the small-eigh kernel's two routes against each other on one card.

The port's ``curvlinops_tpu_torch/solvers/csrc/small_eigh.cu`` keeps A and
V^T either in shared memory (256 threads) or in a device-memory workspace
(1024 threads); ``small_eigh`` switches from the first to the second past
``SHARED_MAX_N``. This script launches both through the kernel's C
interface on the same seeded symmetric matrix at sizes where both take it
(A and V^T in the 227 KB of shared memory a block may hold: float32 to
n = 136, float64 to 118), and prints one JSON line per size and type:

* ``call_ms``: CUDA events around one host call that allocates the outputs
  (and the workspace) and launches, as ``small_eigh`` does; median of 20,
  the routes alternated (shared, global, global, shared);
* ``device_ms``: one launch's device time: a CUDA graph of 20 launches,
  its median replay of 5 divided by 20, as inside LOBPCG's captured loop;
* the sweeps and the eigenvalues' largest distance from float64 ``eigh``.

Run from the repository's root on a machine with a CUDA card and ``nvcc``:
``python3 tools/torch_small_eigh_routes.py``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from curvlinops_tpu_torch.solvers import small_eigh as se  # noqa: E402
from curvlinops_tpu_torch.utils import cuda_build  # noqa: E402

SIZES = {torch.float32: (4, 8, 12, 16, 24, 32, 40, 44, 48, 64, 80, 96, 120, 136),
         torch.float64: (4, 12, 24, 40, 48, 56, 64, 96, 118)}
ROUTES = ("shared", "global")
GRAPH_LAUNCHES, GRAPH_REPLAYS = 20, 5


def launcher(lib, A: torch.Tensor, route: str, sweeps: torch.Tensor | None, alloc: bool):
    """A function launching the kernel on ``A`` (``[1, n, n]``) by ``route``;
    with ``alloc`` it allocates the outputs and workspace at each call, as
    the wrapper does, else once."""
    fn = lib.small_eigh_f32 if A.dtype == torch.float32 else lib.small_eigh_f64
    n, glob = A.shape[-1], route == "global"

    def buffers():
        w = torch.empty(A.shape[:-1], dtype=A.dtype, device=A.device)
        work = ([torch.empty_like(A), torch.empty(A.shape, dtype=torch.float64, device=A.device)]
                if glob else [None, None])
        return w, torch.empty_like(A), work

    fixed = None if alloc else buffers()

    def launch():
        w, V, work = buffers() if alloc else fixed
        err = fn(A.data_ptr(), w.data_ptr(), V.data_ptr(),
                 *(None if t is None else t.data_ptr() for t in work),
                 None if sweeps is None else sweeps.data_ptr(), 1, n, se.MAX_SWEEPS,
                 torch.finfo(A.dtype).eps, int(glob), torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"launch failed ({route}, n = {n}): CUDA error {err}")
        return w, V

    return launch


def median_event_ms(fn, reps: int = 20, warmups: int = 3) -> float:
    for _ in range(warmups):
        fn()
    times = []
    for _ in range(reps):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def graph_ms(launch) -> float:
    """One launch's device time: a graph of ``GRAPH_LAUNCHES`` launches."""
    launch()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(GRAPH_LAUNCHES):
            launch()
    return median_event_ms(graph.replay, reps=GRAPH_REPLAYS, warmups=1) / GRAPH_LAUNCHES


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    lib = cuda_build.load(se.SOURCE, se._bind)
    dev = torch.device("cuda:0")
    for dtype, sizes in SIZES.items():
        for n in sizes:
            gen = torch.Generator().manual_seed(n)
            X = torch.randn((n, n), generator=gen, dtype=torch.float64)
            A = ((X + X.T) / 2).to(dev, dtype)[None].contiguous()
            w64 = torch.linalg.eigvalsh(A[0].double()).flip(-1)
            row = {"n": n, "dtype": str(dtype), "card": smi}
            calls = {r: launcher(lib, A, r, None, alloc=True) for r in ROUTES}
            for r in ROUTES:
                sweeps = torch.zeros(1, dtype=torch.int32, device=dev)
                w, _ = launcher(lib, A, r, sweeps, alloc=True)()
                row[f"{r}_sweeps"] = int(sweeps[0])
                row[f"{r}_max_abs_err"] = float((w[0].double() - w64).abs().max())
            ms = {r: [] for r in ROUTES}
            for r in (*ROUTES, *reversed(ROUTES)):
                ms[r].append(median_event_ms(calls[r]))
            for r in ROUTES:
                row[f"{r}_call_ms"] = sum(ms[r]) / len(ms[r])
                row[f"{r}_device_ms"] = graph_ms(launcher(lib, A, r, None, alloc=False))
            row["eigh_call_ms"] = median_event_ms(lambda: torch.linalg.eigh(A[0]))
            print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
