"""Each cell at a tiny size on the card: a whole run through the kernels,
traced, with its per-layer metrics read and the outputs correct."""

import time

import pytest

from perfbench import run, spec
from perfbench.tests.conftest import CELLS, SEED, tiny_config


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_tiny_cell_on_the_card(bench, card, cell):
    res, lines = run.run_cell(bench, cell, SEED, 1.0, True, card,
                              time.perf_counter(),
                              config=tiny_config(bench, cell))
    assert res["correct"], lines
    assert res["device"]["busy_s"] > 0
    listed = {m["name"] for m in spec.metrics_of(bench, cell, "per_layer")}
    assert set(res["metrics"]) == listed, lines
