"""Device milliseconds an H1 solve call's CUDA graph runs: the program's
timer "krylov.graph", from the two timing events the graph records
before its init and after its WHILE node (ops/graph_loop.py), over the
calls (benchmark/program_spans.py); nothing without a card."""

from benchmark import program_spans as ps


def read(run):
    return ps.ms_per_call("krylov.graph", ps.H1_CALL)
