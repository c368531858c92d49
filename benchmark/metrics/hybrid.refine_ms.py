"""Host milliseconds a Darcy solve call spends in the program's span
"hybrid.refine": the f64 host refinement around the inner PCG
(residuals, the pad and permutation, the copies to and from the card)
(benchmark/program_spans.py)."""

from benchmark import program_spans as ps


def read(run):
    return ps.ms_per_call("hybrid.refine", ps.DARCY_CALL)
