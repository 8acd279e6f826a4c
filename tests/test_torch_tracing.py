"""The port's spans and counters (``utils/profiling.py``): off by default
and invisible to a profiler; on inside ``tracing()``, with parent, root and
sibling ids, the decorator form and a span closed by an exception; nested
around their operations on the profiler's clock; emitted at every site of
the indicator, bootstrap, percentile, sdba (DQM's scaling and detrend,
EQM's adjust and its node passes) and op layers; and without effect on any
output.

The file imports no JAX: its ``cuda`` test runs on the card with

    python -m pytest --noconftest tests/test_torch_tracing.py
"""

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType

from xclim_tpu_torch.core.calendar import date_range
from xclim_tpu_torch.core.dataarray import ClimArray
from xclim_tpu_torch.utils import profiling
from xclim_tpu_torch.utils.profiling import span, tracing

BASE = (1961, 1963)


def _names(trace):
    return [s["name"] for s in trace.spans]


def _kineto(fn):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    return list(prof.profiler.kineto_results.events())


def _tasmax(years=6, cells=(2, 3), seed=0):
    time = date_range("1961-01-01", periods=365 * years, freq="D",
                      calendar="noleap")
    rng = np.random.default_rng(seed)
    doy = np.arange(len(time)) % 365
    x = (285.0 + 10.0 * np.sin(2 * np.pi * doy / 365.0)[:, None, None]
         + rng.normal(0.0, 4.0, (len(time),) + cells)).astype(np.float32)
    coords = {"time": time, "lat": np.arange(cells[0]),
              "lon": np.arange(cells[1])}
    return ClimArray(torch.as_tensor(x), ("time", "lat", "lon"), coords,
                     {"units": "K", "standard_name": "air_temperature",
                      "cell_methods": "time: maximum"}, "tasmax")


def _etccdi(bootstrap):
    """percentile_doy of the base years, then tx90p and WSDI: the outputs."""
    from xclim_tpu_torch.core.percentiles import percentile_doy
    from xclim_tpu_torch.indicators import atmos

    tx = _tasmax()
    base = tx.sel_time(mask=(tx.time.year >= BASE[0])
                       & (tx.time.year <= BASE[1]))
    per = percentile_doy(base, window=5, per=90)
    return [per.data,
            atmos.tx90p(tx, tasmax_per=per, freq="YS",
                        bootstrap=bootstrap).data,
            atmos.warm_spell_duration_index(tx, tasmax_per=per, window=3,
                                            freq="YS",
                                            bootstrap=bootstrap).data]


def _sdba_inputs(trend=0.0):
    """ref, hist and sim over 3 noleap years at 2 x 2 cells; ``trend`` K a
    year in sim."""
    rng = np.random.default_rng(3)
    out = {}
    for name, y0 in (("ref", 1981), ("hist", 1981), ("sim", 2071)):
        time = date_range(f"{y0}-01-01", periods=365 * 3, freq="D",
                          calendar="noleap")
        x = (280.0 + rng.normal(0.0, 3.0, (len(time), 2, 2))).astype(
            np.float32)
        if name == "sim":
            x += (trend * np.arange(len(time)) / 365.0).astype(
                np.float32)[:, None, None]
        out[name] = ClimArray(torch.as_tensor(x), ("time", "lat", "lon"),
                              {"time": time, "lat": np.arange(2),
                               "lon": np.arange(2)}, {"units": "K"}, name)
    return out


def _qdm():
    """QDM train on ref/hist, adjust of sim: the outputs."""
    from xclim_tpu_torch import sdba

    out = _sdba_inputs()
    adj = sdba.QuantileDeltaMapping.train(
        out["ref"], out["hist"], group=sdba.Grouper("time.dayofyear", 31),
        nquantiles=10, kind="+")
    scen = adj.adjust(out["sim"])
    return [adj.ds["af"], adj.ds["hist_q"], scen.data]


def _dqm():
    """DQM train on ref/hist (50 quantiles), adjust of a trended sim: the
    outputs."""
    from xclim_tpu_torch import sdba

    out = _sdba_inputs(trend=0.03)
    adj = sdba.DetrendedQuantileMapping.train(
        out["ref"], out["hist"], group=sdba.Grouper("time.dayofyear", 31),
        nquantiles=50, kind="+")
    scen = adj.adjust(out["sim"])
    return [adj.ds["af"], adj.ds["hist_q"], adj.ds["scaling"], scen.data]


def _eqm():
    """EQM train on ref/hist by month, adjust of sim: the outputs."""
    from xclim_tpu_torch import sdba

    out = _sdba_inputs()
    adj = sdba.EmpiricalQuantileMapping.train(
        out["ref"], out["hist"], group=sdba.Grouper("time.month"),
        nquantiles=10, kind="+")
    scen = adj.adjust(out["sim"])
    return [adj.ds["af"], adj.ds["hist_q"], scen.data]


# ---------------------------------------------------------------- off


def test_off_records_nothing_and_opens_no_range():
    assert profiling._trace is None
    assert span("op.segred") is span("op.segred")   # the shared no-op
    with span("op.segred") as s:
        assert s is None
    events = _kineto(lambda: _etccdi(False))
    assert not [e.name() for e in events
                if e.name().startswith(profiling.PREFIX)]


# ---------------------------------------------------------------- on


def test_ids_parents_roots_and_siblings():
    with tracing() as tr:
        with span("a"):
            with span("b"):
                pass
            with span("c"):
                with span("d"):
                    pass
        with span("e"):
            pass
    assert profiling._trace is None
    rec = {s["name"]: s for s in tr.spans}
    assert _names(tr) == ["a", "b", "c", "d", "e"]
    assert len({s["id"] for s in tr.spans}) == 5
    a, b, c, d, e = (rec[n] for n in "abcde")
    assert a["parent"] is None and a["root"] == a["id"]
    assert b["parent"] == c["parent"] == a["id"]          # siblings
    assert d["parent"] == c["id"]
    assert {b["root"], c["root"], d["root"]} == {a["id"]}
    assert e["parent"] is None and e["root"] == e["id"] != a["id"]
    for s in tr.spans:
        assert s["start_ns"] <= s["end_ns"] and s["host_syncs"] == 0
    assert a["start_ns"] <= b["start_ns"] and d["end_ns"] <= c["end_ns"] \
        <= a["end_ns"] <= e["start_ns"]
    assert tr.counters == dict.fromkeys(profiling.COUNTERS, 0)  # no card here
    assert "eqm_node_passes" in profiling.COUNTERS
    for s in tr.spans:
        assert s["eqm_node_passes"] == 0


def test_decorator_form_and_nesting_of_tracing():
    @span("deco")
    def f(x):
        return x + 1

    assert f(1) == 2 and f.__name__ == "f"
    with tracing() as tr:
        with tracing() as inner:
            assert inner is tr
            assert f(2) == 3
    assert _names(tr) == ["deco"]


def test_an_exception_closes_its_span():
    with tracing() as tr:
        with pytest.raises(KeyError):
            with span("outer"):
                with span("inner"):
                    raise KeyError("x")
        with span("after"):
            pass
    outer, inner, after = tr.spans
    assert inner["end_ns"] is not None and outer["end_ns"] is not None
    assert after["parent"] is None


def test_ranges_nest_around_their_ops_on_the_profilers_clock():
    x = torch.rand(40, 6)

    def run():
        from xclim_tpu_torch.ops.quantile import nan_quantile

        with tracing():
            with span("outer"):
                nan_quantile(x, [0.5, 0.9], axis=0)

    events = _kineto(run)
    by = {e.name(): e for e in events}
    outer, quant = by["xtt:outer"], by["xtt:op.quantile"]
    assert outer.is_user_annotation() and quant.is_user_annotation()
    assert outer.start_ns() <= quant.start_ns() <= quant.end_ns() \
        <= outer.end_ns()
    sort = by["aten::sort"]
    assert quant.start_ns() <= sort.start_ns() <= sort.end_ns() \
        <= quant.end_ns()


def test_a_span_keeps_the_warnings_that_are_no_syncs():
    import warnings

    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        with tracing():
            with span("s"):
                warnings.warn("something else", UserWarning)
    shown = [str(w.message) for w in seen]
    assert "something else" in shown
    assert not any(m.startswith(profiling.SYNC_WARNING) for m in shown)


def test_timed_is_a_span_when_tracing(capsys):
    from xclim_tpu_torch.utils import timed

    with tracing() as tr:
        with timed("blk", sync=lambda: torch.ones(2)) as t:
            with span("inside"):
                pass
    assert t["seconds"] > 0
    assert "[xclim_tpu_torch] blk:" in capsys.readouterr().out
    blk, inside = tr.spans
    assert blk["name"] == "blk" and inside["parent"] == blk["id"]


# ---------------------------------------------------------------- sites


def test_indicator_and_bootstrap_sites():
    with tracing() as tr:
        _etccdi(True)
    names = _names(tr)
    assert names.count("percentiles.doy") == 1
    assert names.count("percentiles.gather") == 1
    assert names.count("indicator.call") == 2
    for stage in ("checks", "compute", "units", "missing", "attrs"):
        assert names.count(f"indicator.{stage}") == 2, stage
    n_base = BASE[1] - BASE[0] + 1
    for name, n in (("bootstrap.plain", 2), ("bootstrap.tables", 2),
                    ("bootstrap.year", 2 * n_base),
                    ("bootstrap.thresholds", 2 * n_base),
                    ("bootstrap.recount", 2 * n_base)):
        assert names.count(name) == n, name
    assert "op.segred" in names and "op.spells" in names
    assert "op.quantile" in names
    rec = {s["id"]: s for s in tr.spans}
    # each year's two halves sit in its year, inside the indicator's compute
    for s in tr.spans:
        if s["name"] in ("bootstrap.thresholds", "bootstrap.recount"):
            year = rec[s["parent"]]
            assert year["name"] == "bootstrap.year"
            assert rec[year["parent"]]["name"] == "indicator.compute"
            assert rec[year["root"]]["name"] == "indicator.call"
    # each recount is counted in its own span, over the year's days alone
    for s in tr.spans:
        recount = s["name"] == "bootstrap.recount"
        assert (s["bootstrap_sliced"], s["bootstrap_whole"]) == (recount, 0)
    assert tr.counters["bootstrap_sliced"] == 2 * n_base


def test_sdba_sites():
    with tracing() as tr:
        _qdm()
    rec = {s["id"]: s for s in tr.spans}
    names = _names(tr)
    assert names.count("sdba.train") == names.count("sdba.adjust") == 1
    assert names.count("sdba.quantiles") == 2
    assert names.count("op.winquantile") == 2
    assert names.count("op.qdmadjust") >= 1
    kids = {n: {rec[s["parent"]]["name"] for s in tr.spans
                if s["name"] == n} for n in ("sdba.units", "sdba.tables")}
    assert kids["sdba.units"] == {"sdba.train", "sdba.adjust"}
    assert kids["sdba.tables"] >= {"sdba.train", "sdba.adjust"}
    assert "sdba.attrs" in names


def test_dqm_sites_and_the_node_pass_counter():
    with tracing() as tr:
        _dqm()
    rec = {s["id"]: s for s in tr.spans}
    names = _names(tr)
    assert names.count("sdba.train") == names.count("sdba.adjust") == 1
    parents = {n: [rec[s["parent"]]["name"] for s in tr.spans
                   if s["name"] == n]
               for n in ("sdba.scaling", "sdba.detrend", "sdba.eqm")}
    # the train's scaling and the adjust's; the fit and the retrend
    assert parents == {"sdba.scaling": ["sdba.train", "sdba.adjust"],
                       "sdba.detrend": ["sdba.adjust", "sdba.adjust"],
                       "sdba.eqm": ["sdba.adjust"]}
    # the scaling comes before the train's two quantile tables; EQM sits
    # between the fit and the retrend
    order = [n for n in names if n in ("sdba.scaling", "sdba.quantiles",
                                       "sdba.detrend", "sdba.eqm")]
    assert order == ["sdba.scaling", "sdba.quantiles", "sdba.quantiles",
                     "sdba.scaling", "sdba.detrend", "sdba.eqm",
                     "sdba.detrend"]
    # one pass a node (50 quantiles and the two end nodes), all in sdba.eqm
    assert tr.counters["eqm_node_passes"] == 52
    (eqm,) = [s for s in tr.spans if s["name"] == "sdba.eqm"]
    assert eqm["eqm_node_passes"] == 52
    assert sum(s["eqm_node_passes"] for s in tr.spans) == 52


def test_node_passes_are_ranges_inside_the_eqm_span():
    """One empty range a pass, on the profiler's clock, inside
    ``sdba.eqm``'s range."""

    def run():
        with tracing():
            _dqm()

    events = _kineto(run)
    eqm = [e for e in events if e.name() == "xtt:sdba.eqm"]
    passes = [e for e in events if e.name() == "xtt:eqm_node_passes"]
    assert len(eqm) == 1 and len(passes) == 52
    assert all(eqm[0].start_ns() <= e.start_ns() <= e.end_ns()
               <= eqm[0].end_ns() for e in passes)


def test_eqm_adjust_opens_the_eqm_span():
    with tracing() as tr:
        _eqm()
    rec = {s["id"]: s for s in tr.spans}
    (eqm,) = [s for s in tr.spans if s["name"] == "sdba.eqm"]
    assert rec[eqm["parent"]]["name"] == "sdba.adjust"
    assert eqm["eqm_node_passes"] == tr.counters["eqm_node_passes"] == 12
    assert "sdba.scaling" not in _names(tr)
    assert "sdba.detrend" not in _names(tr)


def _op_calls():
    from xclim_tpu_torch.ops import (bootstrap, qdmadjust, segred, spells,
                                     winquantile)
    from xclim_tpu_torch.ops.quantile import nan_quantile

    rng = np.random.default_rng(1)
    q = np.linspace(0.05, 0.95, 5).astype(np.float32)
    xg = torch.as_tensor(rng.normal(size=(20, 3, 4)).astype(np.float32))
    af = torch.as_tensor(rng.normal(size=(20, 5, 4)).astype(np.float32))
    x2 = torch.as_tensor(rng.normal(size=(60, 4)).astype(np.float32))
    table = torch.arange(60).reshape(20, 3)
    D = torch.as_tensor(rng.normal(size=(2, 4, 3, 4)).astype(np.float32))
    tabs = bootstrap.topk_rank_tables(D.reshape(2, 12, 4),
                                      np.arange(4).repeat(3), 6)
    return {
        "op.bootstrap": lambda: bootstrap.merge_rank_replaced_year_quantile(
            *tabs, None, None, 1, 0.9, samples=D),
        "op.winquantile": lambda: winquantile.doy_window_quantiles(xg, q, 3),
        "op.qdmadjust": lambda: (qdmadjust.qdm_adjust_doy(xg, af, q),
                                 qdmadjust.qdm_adjust_series(x2, table, af,
                                                             q)),
        "op.segred": lambda: segred.segment_reduce_onepass(
            x2, [0, 30], [30, 30], "sum"),
        "op.spells": lambda: spells.spell_stats(x2, [0, 30], [30, 30], 3,
                                                op=">", thresh=0.0),
        "op.quantile": lambda: nan_quantile(x2, q, axis=0),
    }


@pytest.mark.parametrize("name", sorted(_op_calls()))
def test_each_op_entrys_twin_opens_its_span(name):
    fn = _op_calls()[name]
    off = fn()
    with tracing() as tr:
        on = fn()
    assert name in _names(tr)
    for a, b in zip(*(o if isinstance(o, tuple) else (o,) for o in (off, on))):
        assert torch.equal(a, b)


def test_the_axisquantile_entry_opens_its_span_before_it_refuses_the_cpu():
    from xclim_tpu_torch.ops import axisquantile

    with tracing() as tr:
        with pytest.raises(ValueError, match="no axisquantile kernel"):
            axisquantile.axis_quantile_small(torch.rand(5, 3), [0.5])
    (rec,) = tr.spans
    assert rec["name"] == "op.axisquantile" and rec["end_ns"] is not None


@pytest.mark.parametrize("case", ["bootstrap", "plain", "qdm", "dqm", "eqm"])
def test_outputs_are_bit_equal_with_tracing_on_and_off(case):
    fn = {"bootstrap": lambda: _etccdi(True),
          "plain": lambda: _etccdi(False), "qdm": _qdm, "dqm": _dqm,
          "eqm": _eqm}[case]
    off = fn()
    with tracing() as tr:
        on = fn()
    assert tr.spans
    for a, b in zip(off, on):
        assert a.shape == b.shape
        assert torch.equal(torch.isnan(a), torch.isnan(b))
        assert torch.equal(torch.nan_to_num(a), torch.nan_to_num(b))


# ---------------------------------------------------------------- card


@pytest.mark.cuda
def test_one_item_inside_a_span_counts_one_host_sync():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: host syncs exist only on the card")
    x = torch.ones(1000, device="cuda")
    x.sum().item()                      # warm up outside the trace
    mode = torch.cuda.get_sync_debug_mode()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        with tracing() as tr:
            with span("outer"):
                y = x * 2                       # no sync
                with span("inner"):
                    y.sum().item()
    assert torch.cuda.get_sync_debug_mode() == mode
    rec = {s["name"]: s for s in tr.spans}
    assert rec["inner"]["host_syncs"] == 1 and rec["outer"]["host_syncs"] == 0
    assert tr.counters["host_syncs"] == 1
    events = list(prof.profiler.kineto_results.events())
    inner = next(e for e in events if e.name() == "xtt:inner"
                 and e.device_type() == DeviceType.CPU)
    syncs = [e for e in events if e.name() == "cudaStreamSynchronize"
             and inner.start_ns() <= e.start_ns() <= inner.end_ns()]
    assert len(syncs) == 1
