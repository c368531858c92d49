"""Host milliseconds a Darcy solve call spends in the program's span
"hybrid.reduce": the right-hand side's share of the reduction, the
essential lift g - H (mu * ess) on the whole multiplier system, the free
part g[keep] and its rescaling d * g[keep] (benchmark/program_spans.py).
The free multiplier system itself is built once per operator, under the
span "hybrid.reduce_build", which this reader does not read."""

from benchmark import program_spans as ps


def read(run):
    return ps.ms_per_call("hybrid.reduce", ps.DARCY_CALL)
