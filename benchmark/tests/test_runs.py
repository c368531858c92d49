"""Whole runs of the tiny cells on the CPU (the harness's look for a
card skipped): the result line's shape, the judged sample drawn from the
seed, and the command's refusal without a card."""

import json
import subprocess
import sys

import pytest
import torch

from benchmark import harness, traffic
from conftest import TINY_CELLS, run_tiny

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("workload", [c[0] for c in TINY_CELLS])
@pytest.mark.parametrize("trace", [False, True])
def test_result_line(spec, workload, trace):
    r = run_tiny(spec, workload, trace)
    json.loads(json.dumps(r))
    keys = list(r)
    assert keys[:5] == KEYS and keys[-1] == "checks"
    assert r["correct"] is True and r["failed"] == 0
    assert r["attempted"] >= 1 and r["judged"] >= 1
    cell = harness.resolve(spec, workload)
    want = {m["name"] for m in (cell.per_layer if trace
                                else cell.end_to_end)}
    # device-only metrics (memory, rooflines, the trace's idle share)
    # are not written from a CPU run
    got = set(r["metrics"])
    assert got <= want
    assert {"setup.operators_s", "setup.hierarchy_s"} <= got if trace \
        else "setup_s" in got
    assert any(k.startswith("krylov.iters" if trace else "rhs_per_s")
               for k in got)
    for m in r["metrics"].values():
        assert set(m) == {"value", "unit"}
    dev = r["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    if trace:
        assert {"busy_s", "window_s"} <= set(dev)
        assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
        assert len(r["breakdown"]["idle_gaps"]) <= 10
    for c in r["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]


def test_reservoir_is_drawn_from_the_seed():
    def draw(seed):
        r = traffic.Reservoir(4, seed)
        for i in range(100):
            r.offer(i)
        return r.items
    assert draw(2 ** 33) == draw(2 ** 33)
    assert draw(2 ** 33) != draw(2 ** 33 + 1)
    assert len(set(draw(7))) == 4


def test_source_pool_is_the_seeds():
    mix = {"source": "cellwise_standard_normal", "rhs_per_call": 2,
           "pool_calls": 3}
    a = traffic.source_pool(mix, 2 ** 40 + 1, (2, 3, 4), torch.device("cpu"))
    b = traffic.source_pool(mix, 2 ** 40 + 1, (2, 3, 4), torch.device("cpu"))
    assert len(a) == 3 and a[0].shape == (2, 2, 3, 4)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_command_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                        "h1_struct_128.rhs1", "--seed", "1", "--seconds",
                        "1", "--trace", "0"], cwd=harness.ROOT,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout == ""


def test_calibrate_rehearses_on_the_cpu(spec, tmp_path, capsys):
    from benchmark import calibrate
    path = tmp_path / "spec.json"
    path.write_text(json.dumps(spec))
    out = tmp_path / "readings.jsonl"
    assert calibrate.main(["--workload", "tiny_h1.rhs1", "--seeds", "11",
                           "--control-seeds", "12", "--seconds", "0.2",
                           "--device", "cpu", "--spec", str(path),
                           "--out", str(out)]) == 0
    recs = [json.loads(x) for x in out.read_text().splitlines()]
    assert [r["kind"] for r in recs] == ["setup", "program", "control"]
    limit = json.loads((harness.ROOT / "benchmark/tests/tiny_h1.json")
                       .read_text())["limits"]["res_max"]
    assert recs[1]["checks"]["res_max"] <= limit < recs[2]["checks"]["res_max"]
