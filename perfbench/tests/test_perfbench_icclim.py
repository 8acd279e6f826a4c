"""The cell ``icclim16k.chain`` at a tiny size on the CPU: a run is correct
and a traced run's program line holds the suite's 30 indicator calls and
its run-length spans; the five readers it adds read a number where their
span, counter or entry ran and nothing where they did not; the rooflines
count their work from the call's arguments; the control fails every family
of its numbers; and two broken paths are not correct."""

import copy
import json
import time
from types import SimpleNamespace

import pytest
import torch
from torch.autograd import DeviceType

from perfbench import control, program, roofline, run, spec
from perfbench.callers import icclim as caller
from perfbench.reference import icclim as reference
from perfbench.tests.conftest import SEED
from perfbench.tests.test_perfbench_program import TRACE, Ev, rt

CELL = "icclim16k.chain"
#: the reference's numbers by family, each of which the control must fail
FAMILIES = {
    "temperature statistics": ("TG", "TX", "TN", "TXx", "TXn", "TNx", "TNn",
                               "DTR", "ETR", "vDTR", "TG_MS"),
    "degree days": ("GD4", "HD17"),
    "precipitation amounts": ("RR", "SDII", "RX1day", "RX5day", "PRCPTOT"),
    "counts and spells": ("SU", "TR", "FD", "ID", "CSU", "CFD", "RR1", "CDD",
                          "CWD", "R10mm", "R20mm"),
    "growing season": ("GSL",),
}


def tiny(bench):
    """The cell's configuration at 4 x 4 cells and 3 years."""
    c = copy.deepcopy(spec.config_of(bench, spec.cell(bench, CELL)))
    c["data"].update(grid=[4, 4], years=3)
    c["check"]["cells"] = 16
    return c


def test_the_families_cover_the_outputs():
    names = [n for f in FAMILIES.values() for n in f]
    assert sorted(names) == sorted(reference.NAMES)


def test_a_run_is_correct(bench, cpu):
    res, lines = run.run_cell(bench, CELL, SEED, 0.2, False, cpu,
                              time.perf_counter(), config=tiny(bench))
    assert res["correct"] is True, lines
    assert res["checks"]["calls_differing"]["value"] == 0
    assert len(res["checks"]) == len(reference.NAMES) + 1


def test_a_traced_run_shows_the_suite_and_its_spans(bench, cpu, capsys):
    res, lines = run.run_cell(bench, CELL, SEED + 1, 0.2, True, cpu,
                              time.perf_counter(), config=tiny(bench))
    assert res["correct"] is True, lines
    (line,) = [ln for ln in capsys.readouterr().err.splitlines()
               if ln.startswith("program ")]
    p = json.loads(line[len("program "):])
    counts, calls = p["span_counts"], p["calls"]
    per_call = {k: counts[k] / calls for k in
                ("indicator_calls", "indicator.call", "indicator.missing",
                 "runlength.runs", "runlength.season", "rolling.reduce")}
    assert per_call == {"indicator_calls": 30, "indicator.call": 30,
                        "indicator.missing": 30, "runlength.runs": 4,
                        "runlength.season": 1, "rolling.reduce": 1}
    assert res["metrics"]["indicator.calls_per_call"]["value"] == 30.0
    # no card: no device time, so the span and entry readers read nothing
    for name in ("indicator.missing_ms", "indices.runlength_ms",
                 "segred.roofline_pct", "spells.roofline_pct"):
        assert name not in res["metrics"]


def _reading(with_spans: bool):
    """A made-up call: four kernels, launched in an indicator's masks, in a
    run statistic, in the season parts, and in none of them; the counter
    counted twice (or spans and a counter of other names)."""
    miss, runs, season, calls = (
        ("indicator.missing", "runlength.runs", "runlength.season",
         "indicator_calls") if with_spans else ("a.b", "c.d", "e.f", "g_h"))
    events = [Ev("call", 0, 100), Ev("icclim.suite", 0, 100),
              rt("cudaLaunchKernel", 5, 6, 1),
              rt("cudaLaunchKernel", 25, 26, 2),
              rt("cudaLaunchKernel", 45, 46, 3),
              rt("cudaLaunchKernel", 65, 66, 4),
              Ev("k1", 6, 16, DeviceType.CUDA, corr=1),
              Ev("k2", 26, 46, DeviceType.CUDA, corr=2),
              Ev("k3", 46, 76, DeviceType.CUDA, corr=3),
              Ev("k4", 76, 80, DeviceType.CUDA, corr=4),
              Ev("xtt:" + miss, 0, 20), Ev("xtt:" + runs, 20, 40),
              Ev("xtt:" + season, 40, 60),
              Ev("xtt:" + calls, 1, 1), Ev("xtt:" + calls, 61, 61)]
    return program.read_events(events, {"icclim.suite"}, 1, TRACE)


READERS = {"indicator.missing_ms": 10e-6, "indices.runlength_ms": 50e-6,
           "indicator.calls_per_call": 2.0}


@pytest.mark.parametrize("name", sorted(READERS))
def test_each_new_program_reader(bench, name):
    r = run.metric_reader(name)
    assert r.read(SimpleNamespace(program=_reading(True))) \
        == pytest.approx(READERS[name])
    # a program without the spans or the counter, or without tracing
    assert r.read(SimpleNamespace(program=_reading(False))) is None
    assert r.read(SimpleNamespace(program=None)) is None
    (m,) = [m for m in bench["per_layer"] if m["name"] == name]
    assert m["workloads"] == [CELL] and m["moves"] == "cell_days_per_s"


def meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_the_segred_roofline_reader(bench):
    r = run.metric_reader("segred.roofline_pct")
    assert r.ENTRY == "xclim_tpu_torch.ops.segred:segment_reduce_onepass"
    # the cell's YS sum of one series: 30 years of 16384 cells
    x2, out = meta(10950, 16384), meta(30, 16384)
    nbytes, ops = r.work((x2, [0] * 30, [365] * 30, "sum"), {}, out)
    assert nbytes == 4 * (10950 + 30) * 16384 and ops == 10950 * 16384
    b = roofline.bound(nbytes, ops)
    assert b["bound_by"] == "bytes"
    assert b["bound_ms"] == pytest.approx(4 * 10980 * 16384 / 3.35e9)
    # var and std take two operations a value; the op may come by keyword
    assert r.work((x2, [0], [365]), {"op": "var"}, out)[1] == 2 * ops
    calls = [{"ms": 0.5, "bound_ms": 0.2}, {"ms": 1.5, "bound_ms": 0.6}]
    assert r.read(SimpleNamespace(entries={r.ENTRY: calls})) \
        == pytest.approx(40.0)
    assert r.read(SimpleNamespace(entries={})) is None


def test_the_spells_roofline_reader(bench):
    r = run.metric_reader("spells.roofline_pct")
    assert r.ENTRY == "xclim_tpu_torch.ops.spells:spell_stats"
    # a float32 series and a one-byte condition, 30 years of 16384 cells,
    # four (30, cells) counts each
    outs = tuple(meta(30, 16384) for _ in range(4))
    for dtype, size in ((torch.float32, 4), (torch.bool, 1)):
        x = meta(10950, 16384, dtype=dtype)
        nbytes, ops = r.work((x, [0] * 30, [365] * 30, 1), {}, outs)
        assert nbytes == (size * 10950 + 16 * 30) * 16384
        assert ops == 4 * 10950 * 16384
        assert roofline.bound(nbytes, ops)["bound_by"] == "bytes"
    calls = [{"ms": 1.0, "bound_ms": 0.25}]
    assert r.read(SimpleNamespace(entries={r.ENTRY: calls})) \
        == pytest.approx(25.0)
    assert r.read(SimpleNamespace(entries={})) is None


@pytest.mark.parametrize("seed", [SEED, SEED + 1, SEED + 2])
def test_the_control_fails_every_family(bench, cpu, seed):
    out = control.control(bench, CELL, seed, cpu, config=tiny(bench))
    assert out["fails"]
    failed = {k.split("_outside_")[0].split("_max_abs_")[0]
              for k, v in out["checks"].items() if v["value"] > v["limit"]}
    for family, names in FAMILIES.items():
        assert failed & set(names), family


def _su_threshold_one_kelvin_up(monkeypatch):
    """Days above a threshold (SU, TR) counted above it plus 1 K."""
    from xclim_tpu_torch.indices import _threshold

    t_days = _threshold._t_days

    def shifted(var, thresh, freq, op, constrain):
        k = _threshold.convert_units_to(_threshold.str2pint(thresh), "K")
        return t_days(var, f"{k + 1.0} K", freq, op, constrain)

    monkeypatch.setattr(_threshold, "_t_days", shifted)


def _rx5day_window_of_four(monkeypatch):
    from xclim_tpu_torch.indices import _simple

    rolling = _simple.rolling_reduce
    monkeypatch.setattr(_simple, "rolling_reduce",
                        lambda x, window, op, **kw: rolling(x, window - 1, op,
                                                            **kw))


@pytest.mark.parametrize("broken,fails", [
    (_su_threshold_one_kelvin_up, {"SU_outside_days", "TR_outside_days"}),
    (_rx5day_window_of_four, {"RX5day_max_abs_mm"})])
def test_a_broken_path_is_not_correct(bench, cpu, monkeypatch, broken,
                                      fails):
    broken(monkeypatch)
    res, lines = run.run_cell(bench, CELL, SEED, 0.2, False, cpu,
                              time.perf_counter(), config=tiny(bench))
    assert res["correct"] is False, lines
    failing = {k for k, v in res["checks"].items() if v["value"] > v["limit"]}
    assert failing == fails, failing


def test_the_caller_hands_both_sides_the_shaped_series(bench, cpu):
    config = tiny(bench)
    state = caller.setup(config, SEED, cpu)
    x = caller.inputs(state)
    assert set(x) == {"tas", "tasmax", "tasmin", "pr"}
    assert bool((x["tasmax"] > x["tas"]).all())
    assert bool((x["tasmin"] < x["tas"]).all())
    assert bool((x["pr"] >= 0).all())
    # the dataset the program is handed holds the same tensors
    for k, v in state["raw"].items():
        assert state["ds"][k].data.data_ptr() == v.data_ptr()
    assert state["ds"]["pr"].attrs["units"] == "kg m-2 s-1"


def test_the_reference_imports_neither_jax_nor_the_port():
    import ast
    import pathlib

    roots = set()
    tree = ast.parse(pathlib.Path(reference.__file__).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            roots.add(node.module.split(".")[0])
    assert roots == {"__future__", "torch"}
