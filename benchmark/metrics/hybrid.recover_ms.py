"""Host milliseconds a Darcy solve call spends in the program's span
"hybrid.recover": the un-rescaling and the recovery of (u, p)
(HybridHdivL2.recover) (benchmark/program_spans.py)."""

from benchmark import program_spans as ps


def read(run):
    return ps.ms_per_call("hybrid.recover", ps.DARCY_CALL)
