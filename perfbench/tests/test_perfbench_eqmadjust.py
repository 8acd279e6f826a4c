"""The eqmadjust roofline reader: its bound at the DQM cell's shapes (15.7
GB moved, 4.68 ms, set by bytes), its share of calls, and a program without
the op entry, which it leaves unwrapped."""

import importlib.util
from types import SimpleNamespace

import pytest
import torch

from perfbench import roofline
from perfbench.run import metric_reader

NAME = "eqmadjust.roofline_pct"


def meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_eqmadjust_bound_at_dqm65k():
    r = metric_reader(NAME)
    xf2, out = meta(10950, 65536), meta(10950, 65536)
    table = meta(365, 30, dtype=torch.int64)
    hist_q, af = meta(365, 52, 65536), meta(365, 52, 65536)
    nbytes, ops = r.work((xf2, table, hist_q, af), {"kind": "+"}, out)
    assert nbytes == 4 * (2 * 10950 * 65536 + 2 * 365 * 52 * 65536) \
        + 8 * 365 * 30
    assert ops == 10950 * 65536 * 52
    b = roofline.bound(nbytes, ops)
    assert b["bound_by"] == "bytes"
    assert round(b["bound_ms"], 3) == 4.684


def test_share_of_calls():
    r = metric_reader(NAME)
    calls = [{"ms": 4.0, "bound_ms": 1.0}, {"ms": 6.0, "bound_ms": 1.5}]
    assert r.read(SimpleNamespace(entries={r.ENTRY: calls})) \
        == pytest.approx(25.0)
    assert r.read(SimpleNamespace(entries={})) is None


def test_a_program_without_the_entry_is_not_wrapped(monkeypatch):
    real = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda name, *a: None if name.endswith(".eqmadjust")
                        else real(name, *a))
    r = metric_reader(NAME)
    assert not hasattr(r, "ENTRY")
    assert r.read(SimpleNamespace(entries={})) is None
