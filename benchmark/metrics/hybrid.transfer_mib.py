"""MiB a Darcy solve call copies between host and card: the program's
counters "hybrid.h2d_bytes" (each refinement pass's right-hand side)
and "hybrid.d2h_bytes" (its correction), over the calls
(benchmark/program_spans.py); 0 where the solve ran on the host."""

from benchmark import program_spans as ps


def read(run):
    b = ps.counted_per_call(("hybrid.h2d_bytes", "hybrid.d2h_bytes"),
                            ps.DARCY_CALL)
    return None if b is None else b / 2 ** 20
