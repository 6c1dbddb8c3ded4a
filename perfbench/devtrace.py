"""Reading a ``torch.profiler`` trace of the measured window.

Only the profiler's raw events are read (``kineto_results.events()``):
building ``prof.events()``' trees took minutes on traces with many launches.
Device time is the union of the intervals of every device event (kernels,
copies, sets), clipped to the window, which is the benchmark's own
``perfbench:window`` span; an idle gap is a stretch of the window that no
device event covers, labelled with the innermost benchmark span that was
open on the host when it began.
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field

from perfbench.spans import PREFIX

WINDOW = "window"
TOP = 10


@dataclass
class Trace:
    """What a traced window's metrics and breakdown read."""

    busy_s: float
    window_s: float
    kernel_s: dict = field(default_factory=dict)  # device seconds by event name
    launches: dict = field(default_factory=dict)  # device events by name
    idle_by_span: dict = field(default_factory=dict)  # idle seconds by open span

    def time_of(self, fragment: str) -> float:
        """Device seconds of the events whose name contains ``fragment``."""
        return sum(s for name, s in self.kernel_s.items() if fragment in name)

    def launches_of(self, fragment: str) -> int:
        """Device events whose name contains ``fragment``."""
        return sum(n for name, n in self.launches.items() if fragment in name)

    def idle_percent(self) -> float | None:
        """Share of the window in which no device operation ran, in %;
        ``None`` where none ran at all."""
        return 100.0 * (1.0 - self.busy_s / self.window_s) if self.busy_s > 0 else None

    def breakdown(self) -> dict:
        """The longest device operations and the idle time by open span."""
        ops = sorted(self.kernel_s.items(), key=lambda kv: -kv[1])[:TOP]
        gaps = sorted(self.idle_by_span.items(), key=lambda kv: -kv[1])[:TOP]
        return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": [[n, s] for n, s in gaps]}


def _merged(intervals: list[tuple[int, int]]) -> list[tuple[int, int]]:
    out: list[list[int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def read(prof) -> Trace:
    """The window's device time, the time of each device operation and the
    idle time by the span open on the host."""
    from torch.autograd import DeviceType

    spans, device = [], []
    kernel_s: dict = defaultdict(float)
    launches: dict = defaultdict(int)
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith(PREFIX):
            # the spans, once on the host and once as the device's annotation
            # of the kernels they launched: only the host's is a span
            if e.device_type() != DeviceType.CUDA:
                spans.append((e.start_ns(), e.end_ns(), e.name()[len(PREFIX):]))
        elif e.device_type() == DeviceType.CUDA:
            start, end = e.start_ns(), e.end_ns()
            if end > start:
                device.append((start, end))
                kernel_s[e.name()] += (end - start) / 1e9
                launches[e.name()] += 1
    window = [s for s in spans if s[2] == WINDOW]
    if not window:
        raise RuntimeError("the trace holds no window span")
    w0, w1, _ = window[0]
    busy = _merged([(max(a, w0), min(b, w1)) for a, b in device if b > w0 and a < w1])
    busy_ns = sum(b - a for a, b in busy)

    # idle gaps, labelled by the innermost span open at their start (the
    # record_function ranges of one thread nest)
    gaps, edge = [], w0
    for a, b in busy:
        if a > edge:
            gaps.append((edge, a))
        edge = max(edge, b)
    if edge < w1:
        gaps.append((edge, w1))
    spans.sort()
    idle: dict = defaultdict(float)
    stack: list = []
    at = 0
    for g0, g1 in gaps:
        while at < len(spans) and spans[at][0] <= g0:
            while stack and stack[-1][1] <= spans[at][0]:
                stack.pop()
            stack.append(spans[at])
            at += 1
        while stack and stack[-1][1] <= g0:
            stack.pop()
        idle[stack[-1][2] if stack else "outside spans"] += (g1 - g0) / 1e9
    return Trace(busy_ns / 1e9, (w1 - w0) / 1e9, dict(kernel_s), dict(launches), dict(idle))
