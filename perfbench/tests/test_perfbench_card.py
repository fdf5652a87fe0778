"""On the card: each cell runs a short window and comes out correct with
its own limits. Skips without a card (the `card` fixture decides)."""

from __future__ import annotations

import pytest

from perfbench import harness, registry


@pytest.mark.gpu
@pytest.mark.parametrize("cell", [w["name"] for w in registry.load_benchmark()["workloads"]])
def test_cell_runs_correct_on_the_card(card, cell):
    r = harness.execute(cell, 2**31 + 5, 2.0, False)
    assert r["correct"] is True and r["failed"] == 0
    assert r["device"]["platform"] == "gpu" and r["device"]["memory_peak_bytes"] > 0
