"""Percent of the HBM roofline reached by one fine-level sweep of the
bf16 preconditioner's smoother, alone, at the cell's shape
(benchmark/roofline.py)."""

from benchmark import roofline


def read(run):
    probe = run.probes.get("a0_smooth")
    return None if probe is None else roofline.share(probe, run.device)
