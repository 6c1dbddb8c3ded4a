"""The benchmark's own spans around its calls into the program.

In a traced run each span is a ``torch.profiler.record_function`` range named
``perfbench:<name>`` (so the device trace can say what the host was doing
in an idle gap) and ends in a device synchronize, its host-clock duration
kept by name. In an untraced run a span costs nothing and times nothing: the
end-to-end metrics are taken without the synchronizes.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

PREFIX = "perfbench:"


class Spans:
    """Host-clock spans, kept in memory by name."""

    def __init__(self, traced: bool, synchronize):
        self.traced = traced
        self.synchronize = synchronize
        self.seconds: dict[str, list[float]] = defaultdict(list)
        self.setup_names: dict[str, None] = {}  # in the order set-up ran them

    def drop_warm_up(self) -> None:
        """Forget the window's spans that set-up's warm-up recorded."""
        for name in set(self.seconds) - set(self.setup_names):
            del self.seconds[name]

    @contextlib.contextmanager
    def __call__(self, name: str):
        """A span of the measured window: timed only in a traced run."""
        if not self.traced:
            yield
            return
        from torch.profiler import record_function

        with record_function(PREFIX + name):
            t0 = time.perf_counter()
            yield
            self.synchronize()
            self.seconds[name].append(time.perf_counter() - t0)

    @contextlib.contextmanager
    def setup(self, name: str):
        """A span of the set-up, timed in every run (set-up is not traced)."""
        self.setup_names.setdefault(name)
        t0 = time.perf_counter()
        yield
        self.synchronize()
        self.seconds[name].append(time.perf_counter() - t0)
