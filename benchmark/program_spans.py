"""The program's own spans, timers and counters, per solve call.

parelag_tpu_torch/utils/timing.py keeps a registry of named timers (host
seconds of each span, and "krylov.graph": the card's seconds from the
events inside a compiled solve's graph) and of counters.  It adds up
over the whole process: the warm-up calls, the traced stretch and the
window.  A quantity is read per solve call, a call counted by the span
that opens it once: "hybrid.transform" for HybridHdivL2.solve (Darcy),
"krylov.solve" for a CompiledPcg call (H1).  A program without the
registry's totals, or a run in which the span never ran, reads nothing.
"""

#: the span that a Darcy solve call opens once, and an H1 call
DARCY_CALL, H1_CALL = "hybrid.transform", "krylov.solve"


def registry():
    """({timer: (seconds, count)}, {counter: total}), or None where the
    program keeps no counts."""
    from parelag_tpu_torch.utils.timing import TimeManager
    if not hasattr(TimeManager, "totals"):
        return None
    return TimeManager.totals(), TimeManager.counters()


def calls(timers, call):
    return timers.get(call, (0.0, 0))[1]


def ms_per_call(name, call, minus=None):
    """The timer `name`'s seconds (less the timer `minus`'s) over the
    count of `call`, in milliseconds; None where either never ran."""
    reg = registry()
    if reg is None:
        return None
    timers = reg[0]
    n = calls(timers, call)
    if n == 0 or name not in timers or (minus and minus not in timers):
        return None
    seconds = timers[name][0] - (timers[minus][0] if minus else 0.0)
    return 1e3 * seconds / n


def counted_per_call(names, call):
    """The counters `names` summed over the count of `call` (a counter
    never incremented adds 0); None where `call` never ran."""
    reg = registry()
    if reg is None:
        return None
    timers, counters = reg
    n = calls(timers, call)
    if n == 0:
        return None
    return sum(counters.get(k, 0) for k in names) / n
