"""Host milliseconds a Darcy solve call spends in the program's span
"hybrid.transform": the right-hand side's transform to the multiplier
space (HybridHdivL2.rhs_transform) (benchmark/program_spans.py)."""

from benchmark import program_spans as ps


def read(run):
    return ps.ms_per_call("hybrid.transform", ps.DARCY_CALL)
