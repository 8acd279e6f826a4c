"""The bound arithmetic of the two roofline readers at QDM 16k's shapes,
against the bounds the kernels were held to when they were redesigned
(winquantile 0.586 ms, qdmadjust 0.800 ms, both set by bytes)."""

import pytest
import torch

from perfbench import roofline
from perfbench.run import metric_reader


def meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_winquantile_bound_at_qdm16k():
    r = metric_reader("winquantile.roofline_pct")
    xg, out = meta(365, 30, 16384), meta(365, 52, 16384)
    b = roofline.bound(*r.work((xg, None, 31), {}, out))
    assert b["bound_by"] == "bytes"
    assert round(b["bound_ms"], 3) == 0.586


def test_qdmadjust_bound_at_qdm16k():
    r = metric_reader("qdmadjust.roofline_pct")
    xf2, out = meta(10950, 16384), meta(10950, 16384)
    table, af = meta(365, 30, dtype=torch.int64), meta(365, 52, 16384)
    b = roofline.bound(*r.work((xf2, table, af, None, "+"), {}, out))
    assert b["bound_by"] == "bytes"
    assert round(b["bound_ms"], 3) == 0.800


def test_bound_takes_the_larger_side():
    assert roofline.bound(3.35e9, 0)["bound_ms"] == pytest.approx(1.0)
    b = roofline.bound(0, 67e9)
    assert b["bound_ms"] == pytest.approx(1.0) and b["bound_by"] == "operations"


@pytest.mark.parametrize("name", ["winquantile.roofline_pct",
                                  "qdmadjust.roofline_pct"])
def test_share_of_calls(name):
    from types import SimpleNamespace

    r = metric_reader(name)
    calls = [{"ms": 4.0, "bound_ms": 1.0}, {"ms": 6.0, "bound_ms": 1.5}]
    assert r.read(SimpleNamespace(entries={r.ENTRY: calls})) == pytest.approx(25.0)
    assert r.read(SimpleNamespace(entries={})) is None
