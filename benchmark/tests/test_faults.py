"""The rest of a run with the timed path broken underneath: `correct`
must come out false for every fault the cell can have."""

import numpy as np
import pytest
import torch

from benchmark import harness
from conftest import run_tiny


def _alter(a):
    """One entry moved by the largest magnitude of the answer."""
    if isinstance(a, torch.Tensor):
        a = a.clone()
        a.view(-1)[a.numel() // 2] += a.abs().max()
        return a
    a = np.array(a)
    a[a.size // 2] += np.abs(a).max()
    return a


def _zero(a):
    return torch.zeros_like(a) if isinstance(a, torch.Tensor) \
        else np.zeros_like(a)


def _half(a):
    a = a.clone()
    a[:, a.shape[1] // 2:] = 0
    return a


FAULTS = {
    # the solve hands back its state unchanged (x0 = 0)
    "unchanged": lambda ans: tuple(map(_zero, ans))
    if isinstance(ans, tuple) else _zero(ans),
    # an answer altered where it is produced
    "altered": lambda ans: (_alter(ans[0]), ans[1])
    if isinstance(ans, tuple) else _alter(ans),
    # half of a block of right-hand sides left unsolved
    "half_batch": _half,
}
CASES = [("tiny_h1.rhs1", "unchanged"), ("tiny_h1.rhs1", "altered"),
         ("tiny_h1.rhs16", "unchanged"), ("tiny_h1.rhs16", "altered"),
         ("tiny_h1.rhs16", "half_batch"),
         ("tiny_darcy.rhs1", "unchanged"), ("tiny_darcy.rhs1", "altered")]


@pytest.mark.parametrize("workload,fault", CASES)
def test_fault_is_not_correct(spec, monkeypatch, workload, fault):
    cell = harness.resolve(spec, workload)
    fam = harness.load_module("families", cell.config["family"]).Family
    call = fam.call

    def broken(self, i):
        ans = call(self, i)
        return dict(ans, answer=FAULTS[fault](ans["answer"]))

    monkeypatch.setattr(fam, "call", broken)
    r = run_tiny(spec, workload)
    assert r["correct"] is False, r["checks"]
