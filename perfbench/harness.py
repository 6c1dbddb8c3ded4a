"""Runs one cell of ``BENCHMARK.json``: set-up, the measured window, the
per-layer metrics of a traced run, and the check against the plain
reference.

Everything a cell is made of is found by name:

- its configuration: the file ``BENCHMARK.json`` names, whose ``family``
  names ``families/<family>.py`` (the program's model) and
  ``reference/<family>.py`` (the plain reference and the weights);
- its traffic: ``traffic/<traffic>.json``, whose ``loop`` names
  ``loops/<loop>.py`` (set-up, one unit of work, the end-to-end metrics,
  the outputs the check compares);
- its limits: ``limits/<cell>.json``;
- each per-layer metric: ``metrics/<metric>.py``, a ``read(run)`` that
  returns a number or ``None`` where it finds nothing to read.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "curvlinops_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell_of(bench: dict, name: str) -> dict:
    """The workload entry called ``name``.

    Raises:
        KeyError: If there is none.
    """
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config_of(bench: dict, name: str) -> dict:
    entry = next(c for c in bench["configs"] if c["name"] == name)
    return load_json(ROOT / entry["file"])


def traffic_of(name: str) -> dict:
    return load_json(HERE / "traffic" / f"{name}.json")


def limits_of(cell: str) -> dict:
    return load_json(HERE / "limits" / f"{cell}.json")


def metric_reader(name: str):
    """``metrics/<name>.py``'s ``read``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def cell_metrics(bench: dict, kind: str, cell: str) -> list[dict]:
    """The ``end_to_end`` or ``per_layer`` metrics a cell reports."""
    return [m for m in bench[kind] if cell in m.get("workloads", [cell])]


def forbidden_modules() -> list[str]:
    """Modules of JAX or of the JAX package loaded in this process, compared
    by their whole top-level names."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


@dataclass
class Context:
    """What a loop sees: the configuration and traffic, the seed and its
    generator on the device, the family's program and reference modules,
    the spans."""

    config: dict
    traffic: dict
    seed: int
    device: object
    family: object
    reference: object
    spans: object
    generator: object = None
    synchronize: object = None

    def inputs(self, batches: int) -> tuple[dict, list]:
        """The weights and ``batches`` batches, made on the device from the
        seed (a ResNet's BatchNorm calibrated on the first batch)."""
        weights = self.reference.init_weights(self.config, self.generator, self.device)
        data = self.reference.make_batches(self.config, self.generator, batches, self.device)
        calibrate = getattr(self.reference, "calibrate", None)
        if calibrate is not None:
            calibrate(weights, data[0][0][: self.config["bn_calibration_images"]], self.config)
        return weights, data


@dataclass
class Run:
    """What a per-layer metric reads."""

    config: dict
    traffic: dict
    work: object
    spans: dict = field(default_factory=dict)
    units: int = 0
    window_s: float = 0.0
    trace: object = None

    def span_mean_ms(self, name: str) -> float | None:
        """Mean host milliseconds of the window's spans called ``name``;
        ``None`` where the window has none."""
        spans = self.spans.get(name)
        return 1e3 * sum(spans) / len(spans) if spans else None


def make_context(config: dict, traffic: dict, seed: int, device, traced: bool) -> Context:
    import torch

    from perfbench.spans import Spans

    # the configuration's precision: float32 products stay float32 (cuDNN's
    # convolutions would run in TF32 by default)
    torch.backends.cuda.matmul.allow_tf32 = bool(config.get("tf32", False))
    torch.backends.cudnn.allow_tf32 = bool(config.get("tf32", False))
    cuda = torch.device(device).type == "cuda"
    synchronize = torch.cuda.synchronize if cuda else (lambda: None)
    family = importlib.import_module(f"perfbench.families.{config['family']}")
    reference = importlib.import_module(f"perfbench.reference.{config['family']}")
    generator = torch.Generator(device=device).manual_seed(seed % 2**63)
    return Context(config, traffic, seed, torch.device(device), family, reference,
                   Spans(traced, synchronize), generator, synchronize)


def loop_of(traffic: dict):
    return importlib.import_module(f"perfbench.loops.{traffic['loop']}")


def window(loop, ctx: Context, state: dict, seconds: float) -> tuple[list[float], float]:
    """Whole cycles of units, back to back, until ``seconds`` have passed:
    each unit's seconds and the window's."""
    unit_seconds, i, per_cycle = [], 0, loop.cycle(ctx)
    t0 = time.perf_counter()
    while True:
        for _ in range(per_cycle):
            t = time.perf_counter()
            loop.unit(ctx, state, i)
            unit_seconds.append(time.perf_counter() - t)
            i += 1
        if time.perf_counter() - t0 >= seconds:
            return unit_seconds, time.perf_counter() - t0


def run_cell(bench: dict, cell_name: str, seed: int, seconds: float, trace: bool, device,
             t_start: float, t_imports: float | None = None,
             config: dict | None = None, after=None) -> tuple[dict, list[str]]:
    """One run of a cell (``config`` in place of the cell's own, for tests
    at a tiny size). ``after(ctx, loop, state, ref)``, where given, is
    called once the program's outputs have been compared with the
    reference's ``ref`` and dropped (:func:`control` reads the control
    there).

    Returns:
        ``(result line, check lines)``: the result's keys are the contract's
        and the check lines name each compared number beside its limit.
    """
    import torch

    from perfbench import devtrace, work

    t_imports = t_imports or time.perf_counter()
    cell = cell_of(bench, cell_name)
    config = config or config_of(bench, cell["config"])
    traffic = traffic_of(cell["traffic"])
    limits = limits_of(cell_name)
    ctx = make_context(config, traffic, seed, device, trace)
    loop = loop_of(traffic)
    cuda = ctx.device.type == "cuda"

    state = loop.setup(ctx)
    ctx.synchronize()
    ctx.spans.drop_warm_up()
    gc.collect()
    gc.freeze()

    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        prof = profile(activities=activities)
        prof.__enter__()
        window_span = record_function("perfbench:" + devtrace.WINDOW)
        window_span.__enter__()
    setup_s = time.perf_counter() - t_start
    unit_seconds, window_s = window(loop, ctx, state, seconds)
    trace_summary = None
    if trace:
        window_span.__exit__(None, None, None)
        prof.__exit__(None, None, None)
    memory_peak = torch.cuda.max_memory_allocated(ctx.device) if cuda else 0
    gc.unfreeze()

    e2e = loop.end_to_end(ctx, unit_seconds, window_s)
    spans = {k: list(v) for k, v in ctx.spans.seconds.items()}
    got = loop.outputs(ctx, state)
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    if trace and cuda:
        trace_summary = devtrace.read(prof)
    del prof
    ref = loop.reference_outputs(ctx, state, got, tf32=False)
    numbers = loop.compare(ctx, got, ref)
    del got
    if after is not None:
        after(ctx, loop, state, ref)
    del state, ref
    checks = {n: {"value": v, "limit": limits[n]} for n, v in numbers.items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())

    if trace:
        run = Run(config, traffic, work, spans, len(unit_seconds), window_s, trace_summary)
        metrics = {}
        for m in cell_metrics(bench, "per_layer", cell_name):
            value = metric_reader(m["name"])(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": e2e[m["name"]][0], "unit": e2e[m["name"]][1]}
                   for m in cell_metrics(bench, "end_to_end", cell_name) if m["name"] in e2e}
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}

    device_info = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(ctx.device) if cuda else "cpu",
        "count": 1,
        "memory_peak_bytes": memory_peak,
    }
    result = {"correct": correct, "attempted": len(unit_seconds), "failed": 0,
              "metrics": metrics, "device": device_info}
    if trace_summary is not None:
        device_info["busy_s"] = trace_summary.busy_s
        device_info["window_s"] = trace_summary.window_s
        result["breakdown"] = trace_summary.breakdown()
    result["checks"] = checks
    phases = ", ".join(f"{n} {ctx.spans.seconds[n][0]:.3f}" for n in ctx.spans.setup_names)
    lines = [f"setup_s {setup_s:.3f}: after imports {t_imports - t_start:.3f}, {phases}"]
    lines += [f"check {n}: {c['value']!r} (limit {c['limit']!r})" for n, c in checks.items()]
    return result, lines


def control(bench: dict, cell_name: str, seed: int, seconds: float, device) -> dict:
    """The numbers a cell compares, read for the program (a run of the
    cell, :func:`run_cell`, with a short window) and for the control (the
    reference in the precision one below the configuration's, in the
    program's place) on the same inputs."""
    import torch

    readings = {}

    def lower(ctx, loop, state, ref):
        readings["control"] = loop.compare(
            ctx, loop.reference_outputs(ctx, state, ref, tf32=True), ref)

    result, _ = run_cell(bench, cell_name, seed, seconds, False, device, time.perf_counter(),
                         after=lower)
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    program = {n: c["value"] for n, c in result["checks"].items()}
    return {"seed": seed, "program": program, "control": readings["control"]}
