"""The harness's card readings on the card's machine: one process a
card, each holding a known number of bytes and joined in one NCCL
all_reduce, counted card by card; the same family with every process
on cuda:0 is refused.  Skips without two cards; on a machine with
four:

    python -m pytest benchmark/tests/test_cards_cuda.py -q
"""

import pytest
import torch

import cards_family
from benchmark import harness


@pytest.fixture
def cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices or more")
    return min(4, torch.cuda.device_count())


@pytest.mark.cuda
def test_one_process_a_card_is_counted(cards, tmp_path):
    devices = [torch.device("cuda", i) for i in range(cards)]
    fam = cards_family.Family(devices, "nccl", tmp_path)
    try:
        readings = harness.cell_readings(fam, devices[0])
    finally:
        fam.close()
    assert all(p.returncode == 0 for p in fam.procs), fam.tails()
    used = harness.cards_used(readings, cards)
    info = harness.device_info(devices[0], used, None)
    print("device", info)
    assert info["count"] == cards
    assert info["kind"] == torch.cuda.get_device_name(0)
    assert [r["index"] for r in readings] == list(range(cards))
    for rank, peak in enumerate(info["memory_peak_bytes_per_device"]):
        # the held bytes, the all_reduce's and gather_object's buffers
        want = cards_family.bytes_for(rank)
        assert want <= peak <= want + cards_family.MIB, (rank, peak)
    assert info["memory_peak_bytes"] == max(
        info["memory_peak_bytes_per_device"])


@pytest.mark.cuda
def test_every_process_on_card_0_is_refused(cards, tmp_path):
    devices = [torch.device("cuda", 0)] * cards
    # NCCL refuses two ranks on one card: the processes join by gloo
    fam = cards_family.Family(devices, "gloo", tmp_path)
    try:
        readings = harness.cell_readings(fam, devices[0])
    finally:
        fam.close()
    assert all(p.returncode == 0 for p in fam.procs), fam.tails()
    with pytest.raises(harness.CardError) as e:
        harness.cards_used(readings, cards)
    print("refused:", e.value)
    assert e.value.code == 4
    assert "one process a card" in str(e.value)
    assert f"work reached 1 card(s), the cell asks for {cards}" in str(e.value)
