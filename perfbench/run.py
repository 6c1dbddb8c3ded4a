"""The benchmark's one command: runs one cell of ``BENCHMARK.json``.

    python perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. It sets up the cell (weights and data made on
the device from the seed, every shape warmed), measures a closed loop for
``--seconds`` (whole cycles), checks what the timed path produced against
the plain reference, prints each compared number beside its limit as the
last lines of standard error, and prints one JSON line as the last line of
standard output. ``--trace 1`` profiles the window and reports the cell's
per-layer metrics instead of its end-to-end ones.

It exits nonzero, printing no result, without as many CUDA devices as the
cell asks for, or when JAX or the JAX package is loaded in this process once
the window has closed. The program's kernels build into ``build/`` inside
the checkout, and any other compiler cache is pointed there too.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args()

    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(ROOT / "build" / sub)
    sys.path[0] = str(ROOT)  # the checkout, not this directory
    from perfbench import harness

    bench = harness.manifest()
    cell = harness.cell_of(bench, args.workload)
    import torch

    # the program's host side is one dispatching thread: torch's CPU thread
    # pool is kept to one thread, so a run loads one core of a shared host
    torch.set_num_threads(1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); found {found}",
              file=sys.stderr)
        return 3
    if cell["chips"] != 1:
        print("no cell of this benchmark runs on more than one card yet", file=sys.stderr)
        return 3
    result, lines = harness.run_cell(bench, args.workload, args.seed, args.seconds,
                                     bool(args.trace), "cuda:0", T_START, time.perf_counter())
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"loaded in the benchmark's process: {', '.join(loaded)}", file=sys.stderr)
        return 4
    sys.stdout.flush()
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
