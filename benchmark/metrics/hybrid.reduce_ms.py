"""Host milliseconds a Darcy solve call spends in the program's span
"hybrid.reduce": the free multiplier system (the system's copy, the
essential elimination, the slicing, the rescaling, the CSR copy)
(benchmark/program_spans.py)."""

from benchmark import program_spans as ps


def read(run):
    return ps.ms_per_call("hybrid.reduce", ps.DARCY_CALL)
