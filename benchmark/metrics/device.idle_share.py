"""Percent of the traced stretch's wall time in which no kernel, copy or
set ran on the device (benchmark/trace.py); nothing when the trace is
short (it holds fewer hand-kernel launches than were counted)."""


def read(run):
    t = run.trace
    if t is None or not t.whole or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
