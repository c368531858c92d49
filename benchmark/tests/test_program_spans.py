"""The readers of the program's own spans, timers and counters
(benchmark/program_spans.py) on traced tiny runs on the CPU, and against
a program that keeps no counts."""

import pytest

from benchmark import harness
from benchmark import program_spans as ps
from conftest import run_tiny

DARCY = ["hybrid.transform_ms.spread15", "hybrid.reduce_ms.spread15",
         "hybrid.refine_ms.spread15", "hybrid.recover_ms.spread15",
         "hybrid.transfer_mib.spread15", "krylov.pcg_ms.spread15"]
H1 = {"tiny_h1.rhs1": ["krylov.graph_ms.spread3",
                       "krylov.call_overhead_ms.spread3"],
      "tiny_h1.rhs16": ["krylov.graph_ms.spread1",
                        "krylov.call_overhead_ms.spread1"]}


@pytest.fixture
def registry():
    from parelag_tpu_torch.utils.timing import TimeManager
    TimeManager.clear()
    yield TimeManager
    TimeManager.clear()


def test_darcy_stages_read_per_call(spec, registry):
    r = run_tiny(spec, "tiny_darcy.rhs1", trace=True)
    got = r["metrics"]
    assert set(DARCY) <= set(got)
    ms = [got[m]["value"] for m in DARCY if m.endswith("_ms.spread15")]
    assert all(v > 0 for v in ms)
    # the solve ran on the host: nothing crossed to a card
    assert got["hybrid.transfer_mib.spread15"] == {"value": 0.0,
                                                   "unit": "MiB"}
    calls = registry.totals()[ps.DARCY_CALL][1]
    assert calls >= r["attempted"] + 2          # warm-up, stretch, window


@pytest.mark.parametrize("workload", sorted(H1))
def test_graph_time_reads_nothing_without_a_card(spec, registry, workload):
    want = {m["name"] for m in harness.resolve(spec, workload).per_layer}
    assert set(H1[workload]) <= want
    r = run_tiny(spec, workload, trace=True)
    assert not set(H1[workload]) & set(r["metrics"])
    assert registry.totals()[ps.H1_CALL][1] >= r["attempted"] + 2


def test_readers_read_nothing_from_a_program_without_counts(monkeypatch,
                                                            registry):
    """A program whose registry keeps no counts (no TimeManager.totals)
    reads nothing, whatever its timers hold."""
    from parelag_tpu_torch.utils.timing import span
    with span(ps.DARCY_CALL):
        pass
    with span(ps.H1_CALL):
        pass
    names = DARCY + H1["tiny_h1.rhs1"]
    assert any(harness.metric_reader(m)(None) is not None for m in names)
    monkeypatch.delattr(registry, "totals")
    assert all(harness.metric_reader(m)(None) is None for m in names)


def test_readers_read_nothing_before_a_call(registry):
    names = DARCY + H1["tiny_h1.rhs1"]
    assert all(harness.metric_reader(m)(None) is None for m in names)
