"""Host milliseconds of an H1 solve call outside its graph's run on the
card: the program's span "krylov.solve" (the CompiledPcg call: the
right-hand side's copy, the graph's launch, the host read of the
iterations) less its timer "krylov.graph", over the calls
(benchmark/program_spans.py); nothing without a card."""

from benchmark import program_spans as ps


def read(run):
    return ps.ms_per_call("krylov.solve", ps.H1_CALL, minus="krylov.graph")
