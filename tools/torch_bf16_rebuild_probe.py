"""Trace the host-clock timings of ``chip_smoke.py``'s bfloat16 phase.

Runs ``chip_smoke.bf16_phases`` (ResNet-18 at B=512, then the flash GPT-2
small at B=4, T=1024, each in bfloat16 beside a float32 twin) with its
``timed`` helper wrapped, so that every build and inverse it times also
reports, as one JSON line: the host ms, the device ms between CUDA events
around the call, the garbage collector's pauses inside it (``gc.callbacks``)
and the caching allocator's device allocations, frees and retries
(``torch.cuda.memory_stats``). The calls numbered in ``--profile`` (the
phase's order; the GPT's warm bfloat16 rebuild is 12) also run under
``torch.profiler``, which prints the host operators with the most self time
and the device total.

Run from the repository's root on a machine with a CUDA card and ``nvcc``:
``python3 tools/torch_bf16_rebuild_probe.py --profile 12``.
"""

from __future__ import annotations

import argparse
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from curvlinops_tpu_torch.kfac import kernels  # noqa: E402
from curvlinops_tpu_torch.models import flash_attention as fa  # noqa: E402
from curvlinops_tpu_torch.utils import cuda_build  # noqa: E402

STATS = ("num_device_alloc", "num_device_free", "num_alloc_retries")


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--profile", type=int, nargs="*", default=[12])
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    for source in (kernels.SOURCE, fa.SOURCE):
        cuda_build.build(source)

    pauses: list[float] = []
    started: list[float] = []

    def on_gc(phase, info):
        if phase == "start":
            started.append(time.perf_counter())
        elif started:
            pauses.append((time.perf_counter() - started.pop()) * 1e3)

    gc.callbacks.append(on_gc)
    plain_timed, calls = cs.timed, [0]

    def timed(torch_, fn):
        index = calls[0]
        calls[0] += 1
        before = {k: torch.cuda.memory_stats().get(k, 0) for k in STATS}
        pauses.clear()
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        if index in args.profile:
            from torch.profiler import ProfilerActivity, profile

            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                start.record()
                out, ms = plain_timed(torch_, fn)
                stop.record()
        else:
            start.record()
            out, ms = plain_timed(torch_, fn)
            stop.record()
        stop.synchronize()
        after = torch.cuda.memory_stats()
        print(json.dumps({"call": index, "host_ms": ms, "device_events_ms": start.elapsed_time(stop),
                          "gc_pauses_ms": sum(pauses), "gc_collections": len(pauses),
                          **{k: after.get(k, 0) - before[k] for k in STATS}}), flush=True)
        if index in args.profile:
            print(prof.key_averages().table(sort_by="self_cpu_time_total", row_limit=25))
        return out, ms

    cs.timed = timed
    cs.bf16_phases(torch, torch.device("cuda:0"), smi)


if __name__ == "__main__":
    main()
