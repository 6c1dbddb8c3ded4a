"""Time the small-eigh kernel against its plain version and ``torch.linalg.eigh`` on one card.

The port's ``curvlinops_tpu_torch/solvers/small_eigh.py::small_eigh`` solves
LOBPCG's small symmetric eigenproblems on the card. This script calls it,
through the wrapper, on one seeded symmetric matrix a size and type (float32
at n = 12, 40, 44, 64, 96, 120, 144, 300, 510; float64 at n = 120, 512;
``--sizes`` picks others) and prints one JSON line each:

* ``device_ms``: one launch's device time: a CUDA graph of up to 20 wrapper
  calls, its median replay of 3-5 divided by the calls, as inside LOBPCG's
  captured loop (fewer calls for a slow launch: the graph takes about
  50 ms);
* ``call_ms``: CUDA events around one host call of the wrapper (it
  allocates the outputs and the workspace and launches); median of 5-20;
* ``plain_ms`` and ``eigh_ms``: the plain version (``torch.linalg.eigh``,
  flipped to descending) and ``torch.linalg.eigh`` alone, by CUDA events,
  median of 5-20;
* the wrapper's route, the sweeps, and the eigenvalues' largest distance
  from float64 ``eigh``, absolute and relative to the largest;
* ``bound_ms``: the least time the card could take for an eigendecomposition
  with eigenvectors (as ``chip_smoke.py`` counts it): the larger of the
  bytes (A read, w and V written) at 3.35 TB/s and 9 n^3 flops (the
  symmetric QR algorithm's count) at 165 TFLOP/s (3xTF32) for float32 or
  67 TFLOP/s (the FP64 tensor cores) for float64, whatever the sweeps.

``--both-routes`` adds the other route's device time and sweeps where the
shared route can take the matrix (float32 and float64 at n = 16-48 by
default): the switches (``kernel_route``) sit where they cross. The two
routes rotate in different orders, so one matrix may take a sweep more on
one of them: ``--seeds K`` times K matrices a size (seeds n, n + 1000, ...).

It reads only the wrapper's public names, so a checkout of an earlier
commit runs it too: copy it into that checkout's ``tools/`` and run it
there. Run from the repository's root on a machine with a CUDA card and
``nvcc``: ``python3 tools/torch_small_eigh_routes.py [--sizes f32:120,f64:512]
[--both-routes] [--seeds K]``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from curvlinops_tpu_torch.solvers import small_eigh as se  # noqa: E402

SIZES = ((torch.float32, (12, 40, 44, 64, 96, 120, 144, 300, 510)),
         (torch.float64, (120, 512)))
BOTH_SIZES = tuple((t, (16, 17, 20, 24, 28, 32, *range(33, 45), 46, 48))
                   for t in (torch.float32, torch.float64))
TYPES = {"f32": torch.float32, "f64": torch.float64}
GRAPH_MS = 50.0  # a graph's length, about: it sets the calls a graph holds
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 495e12 / 3, torch.float64: 67e12}  # 3xTF32; FP64 tensor cores


def bound(n: int, dtype: torch.dtype) -> tuple[float, str]:
    """The least ms for ``[n, n]``'s eigenvalues and eigenvectors, and what sets it."""
    size = torch.finfo(dtype).bits // 8
    ops_ms = 9 * n**3 / PEAK_FLOPS[dtype] * 1e3
    bytes_ms = (2 * n * n + n) * size / PEAK_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), "operations" if ops_ms >= bytes_ms else "bytes"


def median_event_ms(fn, reps: int, warmups: int = 1) -> float:
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


def graph_ms(fn, once_ms: float) -> tuple[float, int]:
    """One call's device time from a CUDA graph of calls, and the calls."""
    calls = max(1, min(20, int(GRAPH_MS / max(once_ms, 1e-3))))
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    replays = 5 if once_ms * calls < 200 else 3
    return median_event_ms(graph.replay, reps=replays) / calls, calls


@contextlib.contextmanager
def forced_route(route: str):
    """The wrapper's route choice replaced by ``route`` inside."""
    chosen = se.kernel_route
    se.kernel_route = lambda n: route if chosen(n) else None
    try:
        yield
    finally:
        se.kernel_route = chosen


def other_route(A: torch.Tensor) -> dict:
    """The device time and sweeps of the route the wrapper does not choose."""
    n = A.shape[-1]
    route = "cluster" if se.kernel_route(n) == "shared" else "shared"
    with forced_route(route):
        sweeps = torch.zeros(1, dtype=torch.int32, device=A.device)
        se.small_eigh(A[None], sweeps)
        once = median_event_ms(lambda: se.small_eigh(A), reps=1)
        ms, _ = graph_ms(lambda: se.small_eigh(A), once)
    return {"other_route": route, "other_sweeps": int(sweeps[0]), "other_device_ms": ms}


def row(A: torch.Tensor, smi: str) -> dict:
    n, dtype = A.shape[-1], A.dtype
    w64 = torch.linalg.eigvalsh(A.double()).flip(-1)
    sweeps = torch.zeros(1, dtype=torch.int32, device=A.device)
    w, _ = se.small_eigh(A[None], sweeps)
    torch.cuda.synchronize()
    scale = float(w64.abs().max())
    err = float((w[0].double() - w64).abs().max())
    out = {"n": n, "dtype": str(dtype), "route": se.kernel_route(n), "sweeps": int(sweeps[0]),
           "max_abs_err": err, "rel_err": err / scale if scale else err}
    out["bound_ms"], out["bound_by"] = bound(n, dtype)
    once = median_event_ms(lambda: se.small_eigh(A), reps=1)
    reps = 20 if once < 10 else 5
    out["device_ms"], out["graph_calls"] = graph_ms(lambda: se.small_eigh(A), once)
    out["call_ms"] = median_event_ms(lambda: se.small_eigh(A), reps)
    out["plain_ms"] = median_event_ms(lambda: se.small_eigh_plain(A), reps)
    out["eigh_ms"] = median_event_ms(lambda: torch.linalg.eigh(A), reps)
    out["card"] = smi
    return out


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--sizes", default=None,
                        help="comma-separated type:n, e.g. f32:120,f64:512 (default: all)")
    parser.add_argument("--both-routes", action="store_true",
                        help="time both routes where the shared one can take the matrix")
    parser.add_argument("--seeds", type=int, default=1, help="matrices a size (default 1)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    sizes = BOTH_SIZES if args.both_routes else SIZES
    if args.sizes:
        picked: dict = {}
        for item in args.sizes.split(","):
            t, n = item.split(":")
            picked.setdefault(TYPES[t], []).append(int(n))
        sizes = tuple(picked.items())
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    for dtype, ns in sizes:
        for n in ns:
            for seed in range(n, n + 1000 * args.seeds, 1000):
                gen = torch.Generator().manual_seed(seed)
                X = torch.randn((n, n), generator=gen, dtype=torch.float64)
                A = ((X + X.T) / 2).to(dev, dtype).contiguous()
                out = {"seed": seed, **row(A, smi)}
                if args.both_routes:
                    out.update(other_route(A))
                print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
