"""The control: the plain reference in bfloat16, put in the program's place,
fails its cell's limits on every seed tried (at a tiny size here; at each
cell's own size on the card by ``python3 -m perfbench.control``)."""

import pytest

from perfbench import control
from perfbench.tests.conftest import CELLS, SEED, tiny_config


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", [SEED, SEED + 1, SEED + 2])
def test_bfloat16_reference_is_not_correct(bench, cpu, cell, seed):
    out = control.control(bench, cell, seed, cpu,
                          config=tiny_config(bench, cell))
    assert out["fails"], out["checks"]
