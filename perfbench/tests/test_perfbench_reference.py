"""The plain references: their parts against numpy and loops, and each
cell's run of the port on CPU tensors against them at a tiny size."""

import time

import numpy as np
import pytest
import torch

from perfbench import run
from perfbench.reference import etccdi, qdm
from perfbench.reference.hyndman_fan import quantiles
from perfbench.tests.conftest import CELLS, SEED, tiny_config


@pytest.mark.parametrize("method,ab", [("linear", 1.0), ("median_unbiased", 1 / 3)])
def test_quantiles_are_numpy_s(method, ab):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(5, 37))
    x[1, :10] = np.nan
    x[2, :] = np.nan
    q = np.array([0.0001, 0.1, 0.5, 0.9, 0.9999])
    got = quantiles(torch.as_tensor(x), q, ab, ab).numpy()
    want = np.stack([np.nanquantile(r, q, method=method)
                     if np.isfinite(r).any() else np.full(len(q), np.nan)
                     for r in x])
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def test_spell_days_is_the_loop():
    rng = np.random.default_rng(1)
    above = rng.random((4, 365, 6)) < 0.6
    got = etccdi.spell_days(torch.as_tensor(above), 6).numpy()
    want = np.zeros((4, 6), dtype=np.int64)
    for i in range(4):
        for c in range(6):
            run_ = 0
            for d in range(366):
                if d < 365 and above[i, d, c]:
                    run_ += 1
                else:
                    if run_ >= 6:
                        want[i, c] += run_
                    run_ = 0
    np.testing.assert_array_equal(got, want)


def test_qdm_nodes_are_xsdba_s():
    q = qdm.nodes(50)
    assert len(q) == 52 and q.dtype == np.float32
    assert q[0] == np.float32(1e-4) and q[-1] == np.float32(1 - 1e-4)
    np.testing.assert_allclose(q[1:-1], np.linspace(0.01, 0.99, 50), rtol=1e-6)


@pytest.mark.parametrize("cell", CELLS)
def test_port_on_the_cpu_matches_the_reference(bench, cpu, cell):
    """A whole run but the look for a card, on CPU tensors (the port's
    plain twins): correct, every number within its limit."""
    res, lines = run.run_cell(bench, cell, SEED, 0.2, False, cpu,
                              time.perf_counter(),
                              config=tiny_config(bench, cell))
    assert res["correct"], lines
    assert list(res)[-1] == "checks"
    assert lines[-len(res["checks"]):] == [
        f"check {k} {v['value']!r} limit {v['limit']!r}"
        for k, v in res["checks"].items()]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert "cell_days_per_s" in res["metrics"]
