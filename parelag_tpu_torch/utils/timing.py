"""Named-timer registry and stopwatch (PyTorch).

Counterpart of parelag_tpu/utils/timing.py, a rebuild of the reference
TimeManager/Timer/Watch (src/utilities/ParELAG_TimeManager.hpp:40-146,
ParELAG_Watch.hpp:33): a global registry of named accumulating timers
with RAII scopes and a pretty summary table.  The timer names are the
setup's stage spans (amge/sequence.py: "coarsen: traces", "coarsen: ext
pass2 solve", ...).  Card work is made visible by synchronizing (torch
launches asynchronously) when a timer scope with sync_device closes.
"""

import os
import time
from contextlib import contextmanager

import torch


@contextmanager
def profile_trace(logdir):
    """Capture a profile around a block (torch.profiler, CPU activity
    and, with a card, CUDA activity), written as a Chrome trace to
    logdir/trace.json: the replacement for the reference's compile-time
    elag_trace per-rank call logs (Trace.hpp:20-40)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    os.makedirs(str(logdir), exist_ok=True)
    prof.export_chrome_trace(os.path.join(str(logdir), "trace.json"))


@contextmanager
def named_scope(name):
    """Annotate work for the profiler timeline
    (torch.profiler.record_function)."""
    with torch.profiler.record_function(name):
        yield


class Watch:
    """Simple accumulating stopwatch (ParELAG_Watch.hpp:33)."""

    def __init__(self):
        self._elapsed = 0.0
        self._start = None

    def start(self):
        self._start = time.perf_counter()

    def stop(self):
        if self._start is not None:
            self._elapsed += time.perf_counter() - self._start
            self._start = None

    def reset(self):
        self._elapsed = 0.0
        self._start = None

    def elapsed(self):
        if self._start is not None:
            return self._elapsed + (time.perf_counter() - self._start)
        return self._elapsed


class TimeManager:
    """Global named-timer registry (ParELAG_TimeManager.hpp:40-146)."""

    _timers = {}

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
    def clear(cls):
        cls._timers.clear()

    @classmethod
    def summary(cls) -> str:
        if not cls._timers:
            return "TimeManager: no timers.\n"
        width = max(len(n) for n in cls._timers) + 2
        lines = ["-" * (width + 14),
                 f"{'Timer':<{width}}{'Elapsed (s)':>12}",
                 "-" * (width + 14)]
        for name in sorted(cls._timers):
            lines.append(
                f"{name:<{width}}{cls._timers[name].elapsed():>12.6f}")
        lines.append("-" * (width + 14))
        return "\n".join(lines) + "\n"

    @classmethod
    def print_summary(cls):
        print(cls.summary(), end="")
