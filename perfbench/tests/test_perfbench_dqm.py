"""The cell ``dqm65k.train_adjust`` at a tiny size on the CPU: a traced run
is correct and its program line holds DQM's spans and the node-pass
counter; the four readers it adds read a number where their spans ran and
nothing where they did not; the caller's trend reaches the reference; the
control fails every limit; and a timed path without the detrend is not
correct."""

import copy
import json
import time
from types import SimpleNamespace

import pytest
import torch
from torch.autograd import DeviceType

from perfbench import control, generate, program, run, spec
from perfbench.callers import sdba_trend
from perfbench.tests.conftest import SEED
from perfbench.tests.test_perfbench_program import TRACE, Ev, rt

CELL = "dqm65k.train_adjust"
SPANS = ("sdba.scaling", "sdba.detrend", "sdba.eqm")


def tiny(bench):
    """The cell's configuration at 2 x 3 cells; 30 years, so that the trend
    stands out of a cell's noise as it does at full size."""
    c = copy.deepcopy(spec.config_of(bench, spec.cell(bench, CELL)))
    c["data"].update(grid=[2, 3], years=30)
    c["check"]["cells"] = 6
    return c


def test_a_traced_run_is_correct_and_shows_the_spans(bench, cpu, capsys):
    res, lines = run.run_cell(bench, CELL, SEED, 0.2, True, cpu,
                              time.perf_counter(), config=tiny(bench))
    assert res["correct"] is True, lines
    assert set(res["checks"]) == {"scaling_max_abs_K", "af_max_abs_K",
                                  "hist_q_max_abs_K", "scen_max_abs_K",
                                  "calls_differing"}
    (line,) = [ln for ln in capsys.readouterr().err.splitlines()
               if ln.startswith("program ")]
    p = json.loads(line[len("program "):])
    counts = p["span_counts"]
    calls = p["calls"]
    # a call: scaling in train and adjust, the fit and the retrend, one EQM
    assert {k: counts[k] / calls for k in SPANS} == {
        "sdba.scaling": 2, "sdba.detrend": 2, "sdba.eqm": 1}
    assert counts["eqm_node_passes"] == 52 * calls
    assert res["metrics"]["eqm.node_passes_per_call"]["value"] == 52.0
    # no card: no device time, so the span readers have nothing to read
    for name in ("sdba.eqm_ms", "sdba.detrend_ms", "sdba.scaling_ms"):
        assert name not in res["metrics"]


def _reading(with_spans: bool):
    """A made-up call: three kernels, each launched in one of DQM's spans
    (or in none of them)."""
    names = SPANS if with_spans else ("a.b", "c.d", "e.f")
    events = [Ev("call", 0, 100), Ev("sdba.adjust", 0, 90),
              rt("cudaLaunchKernel", 5, 6, 1),
              rt("cudaLaunchKernel", 25, 26, 2),
              rt("cudaLaunchKernel", 45, 46, 3),
              Ev("k1", 10, 20, DeviceType.CUDA, corr=1),
              Ev("k2", 30, 42, DeviceType.CUDA, corr=2),
              Ev("k3", 50, 80, DeviceType.CUDA, corr=3),
              Ev("xtt:" + names[0], 0, 20), Ev("xtt:" + names[1], 20, 40),
              Ev("xtt:" + names[2], 40, 90)]
    events += [Ev("xtt:eqm_node_passes", 47 + i / 10, 47 + i / 10)
               for i in range(52 if with_spans else 0)]
    return program.read_events(events, {"sdba.adjust"}, 1, TRACE)


READERS = {"sdba.scaling_ms": 10e-6, "sdba.detrend_ms": 12e-6,
           "sdba.eqm_ms": 30e-6, "eqm.node_passes_per_call": 52.0}


@pytest.mark.parametrize("name", sorted(READERS))
def test_each_new_reader(bench, name):
    r = run.metric_reader(name)
    assert r.read(SimpleNamespace(program=_reading(True))) \
        == pytest.approx(READERS[name])
    # a program without the spans, or without tracing, gives nothing
    assert r.read(SimpleNamespace(program=_reading(False))) is None
    assert r.read(SimpleNamespace(program=None)) is None
    # listed for the new cell only, where they move cell_days_per_s
    (m,) = [m for m in bench["per_layer"] if m["name"] == name]
    assert m["workloads"] == [CELL] and m["moves"] == "cell_days_per_s"


def test_the_callers_trend_is_in_the_inputs(bench, cpu):
    config = tiny(bench)
    state = sdba_trend.setup(config, SEED, cpu)
    plain = generate.make(config["data"], SEED, cpu)["sim"]
    trended = sdba_trend.inputs(state)["sim"]
    added = trended - plain.reshape(plain.shape[0], -1)
    years = torch.arange(plain.shape[0], dtype=torch.float64) / 365.0
    want = (0.03 * years).to(torch.float32)
    # the float32 sum of value and trend: within a step of ~290 K
    assert (added - want[:, None]).abs().max() <= 3.1e-5
    assert float(added[-1].mean()) == pytest.approx(0.03 * 10949 / 365,
                                                    abs=1e-4)
    # the program adjusts the same tensor
    assert state["arrays"]["sim"].data is state["raw"]["sim"]


@pytest.mark.parametrize("seed", [SEED, SEED + 1, SEED + 2])
def test_the_control_fails_every_limit(bench, cpu, seed):
    out = control.control(bench, CELL, seed, cpu, config=tiny(bench))
    assert out["fails"]
    assert all(v["value"] > v["limit"] for v in out["checks"].values()), \
        out["checks"]


def test_a_path_without_the_detrend_is_not_correct(bench, cpu, monkeypatch):
    from xclim_tpu_torch.sdba import adjustment

    def scaled_only(xf, V, gid, table, flat_pos, hist_q, af, scaling, *,
                    kind, interp, extrapolation):
        x_sc = adjustment._apply_kind(xf, scaling[gid], kind)
        return adjustment._eqm_adjust_body(
            x_sc, table, flat_pos, hist_q, af, kind=kind, interp=interp,
            extrapolation=extrapolation)

    monkeypatch.setattr(adjustment, "_dqm_adjust_core", scaled_only)
    res, lines = run.run_cell(bench, CELL, SEED, 0.2, False, cpu,
                              time.perf_counter(), config=tiny(bench))
    assert res["correct"] is False, lines
    failing = [k for k, v in res["checks"].items() if v["value"] > v["limit"]]
    assert failing == ["scen_max_abs_K"]


def test_the_reference_imports_neither_jax_nor_the_port():
    import ast
    import pathlib

    from perfbench.reference import dqm

    roots = set()
    tree = ast.parse(pathlib.Path(dqm.__file__).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            roots.add(node.module.split(".")[0])
    assert roots == {"__future__", "torch", "perfbench"}
    from perfbench.reference import qdm, hyndman_fan  # what it reuses

    for mod in (qdm, hyndman_fan):
        text = pathlib.Path(mod.__file__).read_text()
        assert "xclim_tpu" not in text and "jax" not in text
