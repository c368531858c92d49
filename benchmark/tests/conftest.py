"""Fixtures of the benchmark's CPU tests: BENCHMARK.json with the tiny
configurations of this folder added as extra cells."""

import copy

import pytest
import torch

from benchmark import harness

TINY = {"tiny_h1": "benchmark/tests/tiny_h1.json",
        "tiny_darcy": "benchmark/tests/tiny_darcy.json"}
TINY_CELLS = (("tiny_h1.rhs1", "tiny_h1", "rhs1"),
              ("tiny_h1.rhs16", "tiny_h1", "rhs16"),
              ("tiny_darcy.rhs1", "tiny_darcy", "rhs1"))
#: the real cell whose metrics each tiny cell reports
STANDS_FOR = {"tiny_h1.rhs1": "h1_struct_128.rhs1",
              "tiny_h1.rhs16": "h1_struct_128.rhs16",
              "tiny_darcy.rhs1": "darcy_hyb_64.rhs1"}


def tiny_spec():
    spec = copy.deepcopy(harness.load_spec())
    spec["configs"] += [{"name": k, "file": v} for k, v in TINY.items()]
    spec["workloads"] += [{"name": n, "config": c, "traffic": t,
                           "chips": 1} for n, c, t in TINY_CELLS]
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"] += [t for t, real in STANDS_FOR.items()
                               if real in m["workloads"]]
    return spec


@pytest.fixture
def spec():
    return tiny_spec()


CPU = torch.device("cpu")


def run_tiny(spec, workload, trace=False, seed=2 ** 33 + 5, seconds=0.3):
    return harness.run_cell(spec, workload, seed, seconds, trace, CPU,
                            lambda: 0.0)
