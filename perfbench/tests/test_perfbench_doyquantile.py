"""The doyquantile roofline reader: its work at the tx90p cells' shapes
(the base period's series, its table and the thresholds, each moved once:
0.111 ms at 8192 cells, set by bytes), its share of calls, and a program
without the op entry, which it leaves unwrapped."""

import importlib.util
from types import SimpleNamespace

import pytest
import torch

from perfbench import roofline
from perfbench.run import metric_reader

NAME = "doyquantile.roofline_pct"


def meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("cells,lat,bound_ms", [(8192, 64, 0.111),
                                                (4096, 32, 0.055)])
def test_doyquantile_work_at_tx90p(cells, lat, bound_ms):
    r = metric_reader(NAME)
    series = meta(10950, lat, cells // lat)
    table = meta(365, 150, dtype=torch.int32)
    out = meta(1, 365, lat, cells // lat)
    nbytes, ops = r.work((series, table, [0.9], 1 / 3, 1 / 3),
                         {"window": 5, "slides": None}, out)
    assert nbytes == 4 * (10950 * cells + 365 * 150 + 365 * cells)
    assert ops == 4.0 * 365 * cells
    b = roofline.bound(nbytes, ops)
    assert b["bound_by"] == "bytes"
    assert round(b["bound_ms"], 3) == bound_ms


def test_share_of_calls():
    r = metric_reader(NAME)
    calls = [{"ms": 4.0, "bound_ms": 0.1}, {"ms": 6.0, "bound_ms": 0.15}]
    assert r.read(SimpleNamespace(entries={r.ENTRY: calls})) \
        == pytest.approx(2.5)


def test_no_calls_read_none():
    r = metric_reader(NAME)
    assert r.read(SimpleNamespace(entries={})) is None
    assert r.read(SimpleNamespace(entries={r.ENTRY: []})) is None


def test_a_program_without_the_entry_is_not_wrapped(monkeypatch):
    real = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda name, *a: None if name.endswith(".doyquantile")
                        else real(name, *a))
    r = metric_reader(NAME)
    assert not hasattr(r, "ENTRY")
    assert r.read(SimpleNamespace(entries={})) is None
