"""Peaks of the card and the reading of a kernel's share of its roofline.

Bytes are the work's, not the format's: an operator counts its stored
nonzeros (from a host CSR copy with explicit zeros removed) times the
value bytes of the dtype it is applied in, and each vector operand read
once and each output written once; no index bytes for any format, so an
indexed format reads lower and a change of format moves the share only
through time.  Every operator measured here is a sparse apply far below
the card's ratio of operations to bytes, so the bound is bytes over the
HBM rate.  The time is the device's, from a profiler trace of the
applies alone, so an apply of several launches is not read at the rate
the host issues them.
"""

from dataclasses import dataclass
from typing import Callable

import torch

from benchmark import port
from benchmark import trace as tracing

#: published peaks (NVIDIA's data sheet, dense): bytes/s of HBM
HBM_BYTES_PER_S = {
    "H100 SXM": 3.35e12,        # H100 80GB HBM3 (SXM5)
    "H100 PCIe": 2.0e12,
}
#: back-to-back applies traced after the untraced warm-up ones, and the
#: traced ones on each side of them
TIMED_CALLS, WARM_CALLS, PAD_CALLS = 200, 20, 10
#: the marker kernel (torch.cuda._sleep) around the timed applies, and
#: its length in clock cycles
MARK, MARK_CYCLES = "spin_kernel", 1000
#: traces taken at most before a probe is read for nothing
ATTEMPTS = 5


def hbm_peak(kind):
    """HBM bytes/s of the card named `kind` (torch.cuda.get_device_name),
    None for a card not in the table."""
    if "H100" not in kind:
        return None
    return HBM_BYTES_PER_S["H100 PCIe" if "PCIe" in kind else "H100 SXM"]


def csr_nnz(A):
    """Stored nonzeros of a scipy sparse matrix, explicit zeros removed
    (on a copy)."""
    A = A.tocsr(copy=True)
    A.eliminate_zeros()
    return int(A.nnz)


@dataclass
class Probe:
    """One kernel-level operation at the cell's shape: fn() runs it once;
    bytes is what it must move."""
    fn: Callable
    bytes: int


def between_marks(dev):
    """The (start, end, name) device intervals that lie between the first
    two marker kernels, or None without two markers."""
    marks = sorted(d for d in dev if MARK in d[2])
    if len(marks) < 2:
        return None
    lo, hi = marks[0][1], marks[1][0]
    return [d for d in dev if d[0] >= lo and d[1] <= hi and MARK not in d[2]]


def trace_once(fn, device):
    """One profiler trace of fn: PAD_CALLS calls, a marker, TIMED_CALLS
    calls, a marker, PAD_CALLS calls.  Returns (the device's
    (start, end, name) intervals between the markers, or None; the
    program's hand-kernel launches its counters counted over the timed
    calls)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(PAD_CALLS):
            fn()
        torch.cuda._sleep(MARK_CYCLES)
        before = port.counters()
        for _ in range(TIMED_CALLS):
            fn()
        counted = port.launched(port.counters(), before)
        torch.cuda._sleep(MARK_CYCLES)
        for _ in range(PAD_CALLS):
            fn()
        torch.cuda.synchronize(device)
    inner = between_marks([(e.time_range.start, e.time_range.end, e.name)
                           for e in prof.events() if tracing.device_work(e)])
    return inner, counted


def device_seconds_per_call(fn, device, trace=trace_once):
    """fn's device time a call: the union of the device's kernels, copies
    and sets in a profiler trace of TIMED_CALLS back-to-back calls, over
    TIMED_CALLS.  The host's gaps between an apply's launches are not the
    kernels' and do not count.  The timed calls sit between two marker
    kernels, with PAD_CALLS more on each side, since the profiler can
    miss a few launches at the ends of its trace (3 of 200 at 128^3).
    A trace whose timed stretch holds another number of the program's
    hand-kernel launches than its counters counted over it is short and
    read for nothing; the profiler now and then drops a launch inside
    the stretch too, so the trace is taken again, up to ATTEMPTS traces
    in all.  None when every one was short."""
    for _ in range(WARM_CALLS):
        fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    for _ in range(ATTEMPTS):
        inner, counted = trace(fn, device)
        if inner and tracing.hand_launches(inner) == counted:
            busy_us = sum(e - s for s, e in tracing.union(inner))
            return busy_us * 1e-6 / TIMED_CALLS
    return None


def share(probe, device):
    """Percent of the HBM roofline the probe reaches on the card; None
    off the card or on a card without a peak in the table."""
    if device.type != "cuda":
        return None
    peak = hbm_peak(torch.cuda.get_device_name(device))
    if peak is None:
        return None
    seconds = device_seconds_per_call(probe.fn, device)
    return None if seconds is None else 100.0 * probe.bytes / peak / seconds
