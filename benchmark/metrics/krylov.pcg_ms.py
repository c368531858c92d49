"""Host milliseconds a Darcy solve call spends in the program's span
"krylov.pcg": the Python-loop PCG of each refinement pass, its launches
and its host read an iteration (benchmark/program_spans.py)."""

from benchmark import program_spans as ps


def read(run):
    return ps.ms_per_call("krylov.pcg", ps.DARCY_CALL)
