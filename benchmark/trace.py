"""A traced stretch of calls, and what is read from it.

A traced run makes, after its warm-up and before its window, a stretch
of the same calls under torch.profiler, which records the host's ops
and the device's kernels, copies and sets, each call inside a
"bench.call" span.
From the trace: the device's busy time (the union of its intervals)
over the stretch's wall time (first call's start to last call's end),
the device operations that took most time, the idle gaps named by the
innermost host op open at their middle, and the hand-written kernels'
launches it holds against those the program's counters counted over
the same calls.  A trace that holds fewer launches than were counted is
short: no metric is read from it.
"""

import re
import time
from collections import defaultdict
from contextlib import nullcontext
from dataclasses import dataclass, field

from benchmark import port

#: the stretch: calls until it has run this long and holds at least
#: MIN_CALLS calls, or MAX_CALLS calls
STRETCH_S, MIN_CALLS, MAX_CALLS = 1.0, 2, 200
#: entries of each breakdown list
TOP = 10
SPAN = "bench.call"


@dataclass
class Summary:
    busy_s: float
    window_s: float
    hand_traced: int
    hand_counted: int
    calls: int
    device_ops: list = field(default_factory=list)
    idle_gaps: list = field(default_factory=list)

    @property
    def whole(self):
        return self.hand_traced == self.hand_counted > 0


#: host events of the profiler itself, not of the program
PROFILER_OPS = ("Activity Buffer Request",)


def stretch(fam):
    """Trace calls of `fam` (family.call) over one stretch; returns the
    Summary, or None when nothing was traced."""
    tracer = Tracer()
    i = 0
    while not tracer.done:
        with tracer.span():
            fam.call(i)
        tracer.after()
        i += 1
    return tracer.summary()


class Tracer:
    """Drives the profiler over a stretch of calls: wrap each call in
    span(), then tell after()."""

    def __init__(self):
        self.prof = None
        self.t0 = None
        self.calls = 0
        self.done = False
        self.before = None
        self.counted = 0

    def span(self):
        if self.done:
            return nullcontext()
        if self.prof is None:
            from torch.profiler import ProfilerActivity, profile
            self.prof = profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA])
            self.prof.__enter__()
            self.before = port.counters()
            self.t0 = time.perf_counter()
        from torch.profiler import record_function
        return record_function(SPAN)

    def after(self):
        if self.prof is None or self.done:
            return
        self.calls += 1
        if ((time.perf_counter() - self.t0 >= STRETCH_S
             and self.calls >= MIN_CALLS) or self.calls >= MAX_CALLS):
            self.stop()

    def stop(self):
        if self.prof is None or self.done:
            return
        self.counted = port.launched(port.counters(), self.before)
        self.prof.__exit__(None, None, None)
        self.done = True

    def summary(self):
        self.stop()
        if self.prof is None:
            return None
        return summarize(self.prof.events(), self.counted, self.calls)


def _short(name):
    return name.split("(")[0][:120]


def device_work(e):
    """Whether the profiler event e is a kernel, copy or set on the
    device (the spans' own device-side annotations are no device work)."""
    from torch.autograd import DeviceType
    return (e.device_type == DeviceType.CUDA and e.name != SPAN
            and not getattr(e, "is_user_annotation", False))


def union(intervals, lo=float("-inf"), hi=float("inf")):
    """The union of (start, end, ...) intervals clipped to [lo, hi], as
    sorted disjoint [start, end] pairs."""
    merged = []
    for s, e, *_ in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def hand_launches(dev):
    """How many of the (start, end, name) device intervals are launches
    of the program's hand-written kernels."""
    pat = re.compile(r"\b(" + "|".join(sorted(port.kernel_names())) + r")\b")
    return sum(1 for d in dev if pat.search(d[2]))


def summarize(events, counted, calls):
    from torch.autograd import DeviceType
    dev, host, spans = [], [], []
    for e in events:
        iv = (e.time_range.start, e.time_range.end, e.name)
        if e.device_type == DeviceType.CUDA:
            if device_work(e):
                dev.append(iv)
        elif e.name in PROFILER_OPS:
            continue
        elif e.name == SPAN:
            spans.append(iv)
            host.append((iv, e.thread))
        else:
            host.append((iv, e.thread))
    if not spans:
        return None
    w0 = min(s[0] for s in spans)
    w1 = max(s[1] for s in spans)
    hand = hand_launches(dev)
    by_name = defaultdict(float)
    for s, e, name in dev:
        by_name[_short(name)] += (e - s) * 1e-6
    merged = union(dev, w0, w1)
    busy = sum(e - s for s, e in merged)
    gaps, last = [], w0
    for s, e in merged:
        if s > last:
            gaps.append((last, s))
        last = max(last, e)
    if w1 > last:
        gaps.append((last, w1))

    # the innermost host op open at each gap's middle, on the thread
    # that ran the calls (its events nest)
    thread = next(t for (iv, t) in host if iv[2] == SPAN)
    ops = sorted((iv for iv, t in host if t == thread),
                 key=lambda iv: (iv[0], -iv[1]))
    idle = defaultdict(float)
    stack, j = [], 0
    for a, b in sorted(gaps, key=lambda g: g[0] + g[1]):
        mid = 0.5 * (a + b)
        while j < len(ops) and ops[j][0] <= mid:
            while stack and stack[-1][1] <= ops[j][0]:
                stack.pop()
            stack.append(ops[j])
            j += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        idle[_short(stack[-1][2]) if stack else "between calls"] += \
            (b - a) * 1e-6
    top = lambda d: [[k, v] for k, v in
                     sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
    return Summary(busy_s=busy * 1e-6, window_s=(w1 - w0) * 1e-6,
                   hand_traced=hand, hand_counted=counted, calls=calls,
                   device_ops=top(by_name), idle_gaps=top(idle))
