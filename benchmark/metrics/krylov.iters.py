"""Mean PCG iterations a solve call over the window, from the counts
the solves return (Darcy: summed over the refinement passes)."""


def read(run):
    return sum(c.iters for c in run.calls) / len(run.calls)
