"""Percent of the HBM roofline reached by the fine operator the PCG
applies, alone, at the cell's shape (benchmark/roofline.py)."""

from benchmark import roofline


def read(run):
    probe = run.probes.get("a0_apply")
    return None if probe is None else roofline.share(probe, run.device)
