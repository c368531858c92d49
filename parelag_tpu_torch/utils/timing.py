"""Named-timer registry, stopwatch and spans (PyTorch).

Counterpart of parelag_tpu/utils/timing.py, a rebuild of the reference
TimeManager/Timer/Watch (src/utilities/ParELAG_TimeManager.hpp:40-146,
ParELAG_Watch.hpp:33): a global registry of named accumulating timers
with RAII scopes and a pretty summary table.  The timer names are the
setup's stage spans (amge/sequence.py: "coarsen: traces", "coarsen: ext
pass2 solve", ...) and the solve calls' spans (`span`).  Card work is
made visible by synchronizing (torch launches asynchronously) when a
timer scope with sync_device closes; "krylov.graph" holds device
seconds instead, from the CUDA events inside a compiled solve's graph
(solvers/cg.CompiledPcg).  Counters (`counter`) hold counts that are
not times.
"""

import time
from contextlib import contextmanager

import torch


class span:
    """Time a block under `name`: its host seconds and one to the count of
    the registry's timer `name` (TimeManager; a name used twice adds up).
    While a torch.profiler is recording, the block is also a
    record_function range of that name, on the clock of the trace's CUDA
    activity; otherwise the span is two clock reads and a flag check.
    The port's solve calls are spans: "hybrid.transform",
    "hybrid.reduce", "hybrid.refine" and "hybrid.recover" in
    HybridHdivL2.solve ("hybrid.reduce_build" once per reduced system
    it builds), "krylov.pcg" around solvers/cg.pcg and "krylov.solve"
    around a CompiledPcg call."""

    __slots__ = ("name", "t0", "range")

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.range = None
        if torch.autograd._profiler_enabled():
            self.range = torch.profiler.record_function(self.name)
            self.range.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        TimeManager.get_timer(self.name).add(time.perf_counter() - self.t0)
        if self.range is not None:
            self.range.__exit__(*exc)
        return False


def counter(name, n):
    """Add n to the registry's counter `name` (TimeManager.counters()):
    "hybrid.h2d_bytes" and "hybrid.d2h_bytes", the bytes a Darcy solve
    copies to and from the card."""
    TimeManager._counters[name] = TimeManager._counters.get(name, 0) + n


class Watch:
    """Simple accumulating stopwatch (ParELAG_Watch.hpp:33); `count` is
    the number of intervals it has timed."""

    def __init__(self):
        self._elapsed = 0.0
        self._start = None
        self.count = 0

    def start(self):
        self._start = time.perf_counter()

    def stop(self):
        if self._start is not None:
            self.add(time.perf_counter() - self._start)
            self._start = None

    def add(self, seconds):
        """One interval of `seconds` timed elsewhere (a span, the card's
        events)."""
        self._elapsed += seconds
        self.count += 1

    def reset(self):
        self._elapsed = 0.0
        self._start = None
        self.count = 0

    def elapsed(self):
        if self._start is not None:
            return self._elapsed + (time.perf_counter() - self._start)
        return self._elapsed


class TimeManager:
    """Global named-timer registry (ParELAG_TimeManager.hpp:40-146)."""

    _timers = {}
    _counters = {}

    @classmethod
    def get_timer(cls, name) -> Watch:
        if name not in cls._timers:
            cls._timers[name] = Watch()
        return cls._timers[name]

    @classmethod
    @contextmanager
    def add_timer(cls, name, sync_device=False):
        """RAII timer scope (TimeManager::AddTimer); sync_device waits
        for the card's queued work before the timer stops, when this
        process has a CUDA context."""
        w = cls.get_timer(name)
        w.start()
        try:
            yield w
        finally:
            if sync_device and torch.cuda.is_initialized():
                torch.cuda.synchronize()
            w.stop()

    @classmethod
    def elapsed(cls) -> dict:
        """{timer name: seconds} of every timer."""
        return {name: w.elapsed() for name, w in cls._timers.items()}

    @classmethod
    def totals(cls) -> dict:
        """{timer name: (seconds, intervals timed)} of every timer."""
        return {name: (w.elapsed(), w.count)
                for name, w in cls._timers.items()}

    @classmethod
    def counters(cls) -> dict:
        """{counter name: total} of every counter."""
        return dict(cls._counters)

    @classmethod
    def clear(cls):
        cls._timers.clear()
        cls._counters.clear()

    @classmethod
    def summary(cls) -> str:
        if not cls._timers and not cls._counters:
            return "TimeManager: no timers.\n"
        width = max(len(n) for n in
                    (*cls._timers, *cls._counters, "Counter")) + 2
        rule = "-" * (width + 22)
        lines = [rule, f"{'Timer':<{width}}{'Elapsed (s)':>12}{'Count':>10}",
                 rule]
        for name in sorted(cls._timers):
            w = cls._timers[name]
            lines.append(f"{name:<{width}}{w.elapsed():>12.6f}{w.count:>10}")
        if cls._counters:
            lines += [rule, f"{'Counter':<{width}}{'Total':>22}", rule]
            lines += [f"{name:<{width}}{cls._counters[name]:>22}"
                      for name in sorted(cls._counters)]
        lines.append(rule)
        return "\n".join(lines) + "\n"

    @classmethod
    def print_summary(cls):
        print(cls.summary(), end="")
