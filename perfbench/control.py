"""Readings for a cell's limits: for each seed, in one process, the numbers
the cell compares for the program (a short window at the cell's own sizes)
and for the control (the plain reference in the precision one below the
configuration's, TF32 for float32, put in the program's place on the same
inputs). The benchmark's runs do not run it.

    python perfbench/control.py --workload <cell> --seconds 2 --seeds 11 12 13

prints one JSON line a seed.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seconds", type=float, default=2.0)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    args = parser.parse_args()
    sys.path[0] = str(ROOT)
    import torch

    from perfbench import harness

    if not torch.cuda.is_available():
        print("control.py needs a CUDA device", file=sys.stderr)
        return 3
    bench = harness.manifest()
    for seed in args.seeds:
        print(json.dumps({"workload": args.workload,
                          **harness.control(bench, args.workload, seed, args.seconds, "cuda:0")}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
