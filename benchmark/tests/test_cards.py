"""A cell's `chips` held to what its processes read of their cards, on
the CPU: the result's `device` worked out from one reading a process,
and a run whose work missed its cards, or one of whose processes loaded
JAX, gives no result."""

import copy
import io
import json
import sys
from contextlib import redirect_stdout

import pytest
import torch

import cards_family
from benchmark import harness, run
from conftest import CPU, run_tiny

GIB = 2 ** 30


def reading(index, peak, name="NVIDIA H100 80GB HBM3", forbidden=()):
    return dict(card=f"GPU-{index:08d}", index=index, name=name,
                peak_bytes=peak, pid=1000 + index, forbidden=list(forbidden))


def spec_with_cell(spec, chips, cell="tiny_h1.x4"):
    """The tiny spec with one more cell: tiny_h1 under rhs1 on `chips`
    cards, reporting what tiny_h1.rhs1 reports."""
    spec = copy.deepcopy(spec)
    spec["workloads"].append({"name": cell, "config": "tiny_h1",
                              "traffic": "rhs1", "chips": chips})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "tiny_h1.rhs1" in m.get("workloads", []):
            m["workloads"].append(cell)
    return spec


@pytest.fixture
def fake_family(monkeypatch):
    """Makes the tiny H1 family a multi-card one whose started processes
    read `readings[0]`: it takes `devices` and has cards()."""
    fam = harness.load_module("families", "h1_struct")
    base = fam.Family
    readings = [[]]
    seen = {}

    class MultiCard(base):
        def __init__(self, config, mix, device, spans, devices):
            seen["devices"] = devices
            super().__init__(config, mix, device, spans)

        def cards(self):
            return readings[0]

    monkeypatch.setattr(fam, "Family", MultiCard)
    return readings, seen


def test_one_card_device():
    cards = harness.cards_used([reading(0, 7380656640)], 1)
    info = harness.device_info(torch.device("cuda", 0), cards, None)
    assert info == dict(platform="gpu", kind="NVIDIA H100 80GB HBM3",
                        count=1, memory_peak_bytes=7380656640,
                        memory_peak_bytes_per_device=[7380656640])


def test_one_card_run_on_the_cpu(spec):
    r = run_tiny(spec, "tiny_h1.rhs1")
    dev = r["device"]
    assert dev["count"] == 1 and dev["kind"] == "cpu"
    assert dev["memory_peak_bytes"] > 0
    assert dev["memory_peak_bytes_per_device"] == [dev["memory_peak_bytes"]]


def test_four_cards_counted_with_the_fullest_peak(spec, fake_family):
    readings, seen = fake_family
    peaks = [3 * GIB, 5 * GIB, 4 * GIB]
    readings[0] = [reading(i + 1, p, name="cpu") for i, p in enumerate(peaks)]
    r = run_tiny(spec_with_cell(spec, 4), "tiny_h1.x4")
    assert seen["devices"] == [torch.device("cpu", i) for i in range(4)]
    dev = r["device"]
    assert dev["count"] == 4 and dev["kind"] == "cpu"
    own = dev["memory_peak_bytes_per_device"][0]
    assert dev["memory_peak_bytes_per_device"] == [own] + peaks
    assert dev["memory_peak_bytes"] == max(own, 5 * GIB)
    assert r["correct"] is True


@pytest.mark.parametrize("got", [
    # a family that starts no process and has no cards(): card 0 alone
    None,
    # processes started but their work never reached a card
    [reading(1, 0, "cpu"), reading(2, 0, "cpu"), reading(3, 0, "cpu")],
    # two processes read one card
    [reading(1, GIB, "cpu"), reading(1, GIB, "cpu"), reading(3, GIB, "cpu")],
    # a process gave no reading
    [reading(1, GIB, "cpu"), None, reading(3, GIB, "cpu")],
], ids=["no_cards", "no_work", "shared", "missing"])
def test_four_card_cell_on_fewer_cards_fails(spec, fake_family, monkeypatch,
                                             got):
    readings, _ = fake_family
    if got is None:
        fam = harness.load_module("families", "h1_struct")
        monkeypatch.delattr(fam.Family, "cards")
    else:
        readings[0] = got
    with pytest.raises(harness.CardError) as e:
        run_tiny(spec_with_cell(spec, 4), "tiny_h1.x4")
    assert e.value.code == 4
    assert "the cell asks for 4" in str(e.value)


def test_cards_of_other_names_fail():
    with pytest.raises(harness.CardError, match="different kinds"):
        harness.cards_used([reading(0, GIB), reading(1, GIB, "NVIDIA A100")],
                           2)


def test_more_cards_than_asked_fail():
    with pytest.raises(harness.CardError, match="asks for 1"):
        harness.cards_used([reading(0, GIB), reading(1, GIB)], 1)


@pytest.mark.parametrize("where", [0, 2])
def test_jax_in_a_process_fails(where):
    got = [reading(i, GIB) for i in range(4)]
    got[where]["forbidden"] = ["jax", "jax._src"]
    with pytest.raises(harness.CardError, match="jax") as e:
        harness.cards_used(got, 4)
    assert e.value.code == 3


def test_reading_names_the_jax_package(monkeypatch):
    monkeypatch.setitem(sys.modules, "parelag_tpu.fake", object())
    assert "parelag_tpu.fake" in harness.card_reading(CPU)["forbidden"]


def _run_main(monkeypatch, spec, cell, chips):
    """benchmark.run's main with the look for cards passed and the cell
    run on the CPU; returns (exit code, standard output)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: chips)
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: None)
    monkeypatch.setattr(harness, "load_spec", lambda: spec)
    monkeypatch.setattr(harness, "set_cache_dirs", lambda: None)
    real = harness.run_cell
    monkeypatch.setattr(
        harness, "run_cell",
        lambda spec, w, seed, s, trace, device, clock:
        real(spec, w, seed, s, trace, CPU, clock))
    out = io.StringIO()
    with redirect_stdout(out):
        rc = run.main(["--workload", cell, "--seed", str(2 ** 33 + 9),
                       "--seconds", "0.3", "--trace", "0"])
    return rc, out.getvalue()


def test_command_prints_no_result_when_cards_fall_short(spec, fake_family,
                                                        monkeypatch, capsys):
    readings, _ = fake_family
    readings[0] = [reading(1, GIB, "cpu")]
    rc, out = _run_main(monkeypatch, spec_with_cell(spec, 4), "tiny_h1.x4", 4)
    assert rc == 4 and out == ""
    assert "work reached 2 card(s), the cell asks for 4" in \
        capsys.readouterr().err


def test_command_prints_no_result_when_a_process_loaded_jax(
        spec, fake_family, monkeypatch, capsys):
    readings, _ = fake_family
    readings[0] = [reading(i, GIB, "cpu") for i in (1, 2)]
    readings[0][1]["forbidden"] = ["jaxlib"]
    rc, out = _run_main(monkeypatch, spec_with_cell(spec, 3, "tiny_h1.x3"),
                        "tiny_h1.x3", 3)
    assert rc == 3 and out == ""
    assert "jaxlib" in capsys.readouterr().err


def test_command_prints_the_one_card_result(spec, monkeypatch):
    rc, out = _run_main(monkeypatch, spec, "tiny_h1.rhs1", 1)
    assert rc == 0
    assert json.loads(out.splitlines()[-1])["device"]["count"] == 1


@pytest.mark.parametrize("shared", [False, True], ids=["own", "shared"])
def test_processes_on_the_cpu_read_through_the_group(tmp_path, shared):
    """Two real processes in a gloo group: the measuring process and the
    one the family starts each take card_reading, gathered to rank 0 as a
    family's cards() does; two cards are counted, one card read by both
    is refused."""
    devices = [CPU, CPU] if shared else [torch.device("cpu", i)
                                         for i in range(2)]
    fam = cards_family.Family(devices, "gloo", tmp_path)
    try:
        readings = harness.cell_readings(fam, devices[0])
    finally:
        fam.close()
    assert [p.returncode for p in fam.procs] == [0], fam.tails()
    assert [r["pid"] for r in readings][1] == fam.procs[0].pid
    if shared:
        with pytest.raises(harness.CardError, match="one process a card"):
            harness.cards_used(readings, 2)
    else:
        cards = harness.cards_used(readings, 2)
        info = harness.device_info(CPU, cards, None)
        assert info["count"] == 2 and info["kind"] == "cpu"
        assert info["memory_peak_bytes"] == max(
            r["peak_bytes"] for r in readings)
