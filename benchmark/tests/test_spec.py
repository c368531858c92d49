"""BENCHMARK.json against the rules of its format, and every piece it
names resolved by name from data."""

import json
import re

import pytest

from benchmark import harness

SPEC = harness.load_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTH = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|state|"
                   r"projection|head|expansion|experts_per")


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"][:3] == ["python3", "-m", "benchmark.run"]
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_names_units_and_text():
    entries = (SPEC["configs"] + SPEC["workloads"] + SPEC["end_to_end"]
               + SPEC["per_layer"])
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
        for k in ("why", "layer"):
            if k in e:
                assert 1 <= len(e[k]) <= 200 and "\n" not in e[k]
    for c in SPEC["configs"]:
        assert 1 <= len(c["source"]) <= 200
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in SPEC[kind]]
        assert len(names) == len(set(names)), kind
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")


def test_configs():
    used = {w["config"] for w in SPEC["workloads"]}
    for c in SPEC["configs"]:
        assert c["name"] in used
        assert c["file"].startswith("benchmark/configs/")
        cfg = json.loads((harness.ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"]
        assert cfg["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
        for k in c["reduced"]:
            assert NAME.match(k) and not WIDTH.search(k), k


def test_end_to_end_bounds():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
def test_cell_resolves_and_reports(workload):
    cell = harness.resolve(SPEC, workload)
    assert cell.workload["chips"] in (1, 4)
    assert len(cell.workload["why"]) <= 200
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2 and cell.per_layer
    fam = harness.load_module("families", cell.config["family"])
    ref = harness.load_module("reference", cell.config["family"])
    assert hasattr(fam, "Family") and hasattr(ref, "judge")
    assert hasattr(ref, "solve") and cell.config["limits"]
    for key in ("source", "rhs_per_call", "pool_calls", "judged_calls"):
        assert key in cell.mix


@pytest.mark.parametrize("metric", [m["name"] for m in
                                    SPEC["end_to_end"] + SPEC["per_layer"]])
def test_metric_reader_by_name(metric):
    assert callable(harness.metric_reader(metric))


def test_tier_reads_as_its_quantity():
    assert harness.metric_reader("rhs_per_s.spread3") is \
        harness.metric_reader("rhs_per_s")
    assert harness.metric_reader("kernels.spread15.a0_apply_roofline") is \
        harness.load_module("metrics", "kernels.a0_apply_roofline").read
    for bad in ("rhs_per_s.noisy", "no_such.metric"):
        with pytest.raises(FileNotFoundError):
            harness.metric_reader(bad)
