"""The reading of a profiler trace, on made-up events, and the guards a
run keeps."""

import json
import sys
from types import SimpleNamespace

import pytest
import torch
from torch.autograd import DeviceType

from perfbench import run, trace


class Ev:
    def __init__(self, name, start, end, device=DeviceType.CPU):
        self._n, self._s, self._e, self._d = name, start, end, device

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e

    def device_type(self):
        return self._d


CUDA = DeviceType.CUDA
EVENTS = [Ev("call", 0, 100), Ev("call", 100, 200),
          Ev("stage", 0, 90), Ev("aten::sort", 5, 20),
          Ev("stage", 100, 190), Ev("cudaDeviceSynchronize", 150, 190),
          Ev("k1", 10, 50, CUDA), Ev("k2", 40, 60, CUDA),
          Ev("Memcpy DtoD", 120, 150, CUDA), Ev("k1", 160, 170, CUDA),
          Ev("call", 150, 190, CUDA), Ev("outside", 300, 400, CUDA)]


def test_busy_window_launches_and_gaps():
    p = trace.read_profile(EVENTS, {"stage"}, calls=2)
    assert p["window_s"] == pytest.approx(200e-9)
    # busy: [10, 60] + [120, 150] + [160, 170] = 90 ns
    assert p["busy_s"] == pytest.approx(90e-9)
    assert p["kernels"] == 3 and p["calls"] == 2
    assert p["device_ops"][0] == ["k1", pytest.approx(50e-9)]
    gaps = dict(p["idle_gaps"])
    # 0..10 and 60..120 in a stage with no host op open; 150..160 and
    # 170..200 while the host waits in a synchronize
    assert gaps == {"stage / python": pytest.approx(70e-9),
                    "stage / cudaDeviceSynchronize": pytest.approx(40e-9)}
    assert sum(gaps.values()) == pytest.approx(p["window_s"] - p["busy_s"])
    json.dumps(p)


def test_no_call_reads_nothing():
    assert trace.read_profile([Ev("k1", 0, 1, CUDA)], set(), 1) == {}


@pytest.mark.parametrize("name", ["device.idle_pct", "device.launches_per_call"])
def test_device_readers(name):
    r = run.metric_reader(name)
    p = trace.read_profile(EVENTS, {"stage"}, calls=2)
    value = r.read(SimpleNamespace(profile=p))
    assert value == pytest.approx(55.0 if name == "device.idle_pct" else 1.5)
    assert r.read(SimpleNamespace(profile={})) is None


def test_banned_modules_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "xclim_tpu_torch_fake", object())
    monkeypatch.setitem(sys.modules, "jaxlibrary", object())
    assert run.banned_modules() == []
    monkeypatch.setitem(sys.modules, "xclim_tpu.core", object())
    monkeypatch.setitem(sys.modules, "jax", object())
    assert run.banned_modules() == ["jax", "xclim_tpu.core"]


def test_no_card_no_result(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "qdm65k.adjust", "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""
    assert "CUDA" in out.err
