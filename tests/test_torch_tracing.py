"""The port's spans and counters (``utils/profiling.py``): off by default
and invisible to a profiler; on inside ``tracing()``, with parent, root and
sibling ids, the decorator form and a span closed by an exception; nested
around their operations on the profiler's clock; emitted at every site of
the indicator, bootstrap, percentile, sdba (DQM's scaling and detrend,
EQM's adjust and its node passes), ensembles (the percentiles, the
robustness with its moments and incomplete beta, and the continued
fraction's steps), run-length (the run statistics, the season parts and
the rolling reduction, never one inside another of its name), indicator
call counter and op layers; and without effect on any output.

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


def _ensemble_calls():
    """ensemble_percentiles and the t-test robustness_fractions of 30
    members (365 noleap days, 2 x 3 cells, a warming of 0-2 K over the year
    by member, cell (0, 0) missing in members 0-4): the outputs."""
    from xclim_tpu_torch.ensembles import (create_ensemble,
                                           ensemble_percentiles,
                                           robustness_fractions)

    time = date_range("2000-01-01", periods=365, freq="D", calendar="noleap")
    rng = np.random.default_rng(5)
    ramp = np.linspace(0.0, 1.0, 365)[:, None, None]
    coords = {"time": time, "lat": np.arange(2), "lon": np.arange(3)}
    members = []
    for m, warm in enumerate(rng.uniform(0.0, 2.0, 30)):
        x = (285.0 + rng.normal(0.0, 5.0, (365, 2, 3))
             + warm * ramp).astype(np.float32)
        if m < 5:
            x[:, 0, 0] = np.nan
        members.append(ClimArray(torch.as_tensor(x), ("time", "lat", "lon"),
                                 coords, {"units": "K"}, "tas"))
    ens = create_ensemble(members)
    per = ensemble_percentiles(ens, values=[10, 50, 90])
    rf = robustness_fractions(ens.isel(time=slice(183, 365)),
                              ens.isel(time=slice(0, 182)), test="ttest")
    return [p.data for p in per.values()] + [rf[k].data for k in rf.keys()]


def _icclim_suite():
    """The benchmark caller's ECA&D suite (30 calls of the icclim module
    over tas, tasmax, tasmin and pr) on 2 x 3 cells x 3 noleap years of CPU
    tensors: the outputs."""
    import copy
    import json
    import pathlib

    from perfbench.callers import icclim as caller

    path = (pathlib.Path(caller.__file__).resolve().parent.parent
            / "configs" / "icclim_ecad_16k.json")
    config = copy.deepcopy(json.loads(path.read_text()))
    config["data"].update(grid=[2, 3], years=3)
    state = caller.setup(config, 5, torch.device("cpu"))
    state["config"] = config
    caller.suite(state)
    return [o.data for o in state["outs"]]


def _run_length_calls():
    """The run-length API's entries on a bool series over 3 noleap years of
    2 cells (runs of every length, a season in most years)."""
    from xclim_tpu_torch.indices import run_length as rl

    time = date_range("1991-01-01", periods=3 * 365, freq="D",
                      calendar="noleap")
    rng = np.random.default_rng(2)
    doy = np.arange(len(time)) % 365
    p = 0.5 + 0.45 * np.sin(2 * np.pi * (doy - 105) / 365.0)[:, None]
    cond = ClimArray(torch.as_tensor(rng.random((len(time), 2)) < p),
                     ("time", "x"), {"time": time, "x": np.arange(2)},
                     {"units": ""}, "cond")
    return {
        "season": lambda: rl.season(cond, 4, mid_date="07-01", freq="YS"),
        "season_whole": lambda: rl.season_length(cond.isel(
            time=slice(0, 365)), 4, mid_date="07-01"),
        "first_run_after_date": lambda: rl.first_run_after_date(cond, 3),
        "last_run_before_date": lambda: rl.last_run_before_date(cond, 3),
        "first_run_before_date": lambda: rl.first_run_before_date(cond, 3),
        "run_end_after_date": lambda: rl.run_end_after_date(cond, 3),
        "longest_run": lambda: rl.longest_run(cond, freq="YS"),
        "longest_run_whole": lambda: rl.longest_run(cond),
        "windowed_run_count": lambda: rl.windowed_run_count(cond, 3, "YS"),
        "windowed_run_events": lambda: rl.windowed_run_events(cond, 3, "YS"),
        "windowed_max_run_sum": lambda: rl.windowed_max_run_sum(
            cond.astype(torch.float32), 2, "YS"),
        "rle_statistics_q90": lambda: rl.rle_statistics(cond, "q90", 2, "YS"),
        "first_last_run": lambda: (rl.first_run(cond, 3, "YS"),
                                   rl.last_run(cond, 3, "YS")),
        "keep_longest_run": lambda: rl.keep_longest_run(cond, "YS"),
    }


# ---------------------------------------------------------------- off


def test_off_records_nothing_and_opens_no_range():
    assert profiling._trace is None
    assert span("op.segred") is span("op.segred")   # the shared no-op
    with span("op.segred") as s:
        assert s is None
    events = _kineto(lambda: _etccdi(False))
    assert not [e.name() for e in events
                if e.name().startswith(profiling.PREFIX)]


def test_off_the_ensembles_record_and_count_nothing():
    events = _kineto(_ensemble_calls)
    assert profiling._trace is None
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
    assert tr.counters == {"host_syncs": 0}            # no card here
    # a counter never counted reads 0, in the block and in every span
    assert tr.counters["eqm_node_passes"] == 0
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


# ---------------------------------------------------------------- counts


def test_count_adds_an_int_amount_to_the_innermost_span():
    with tracing() as tr:
        profiling.count("c", 5)
        with span("outer"):
            profiling.count("c")
            with span("inner"):
                profiling.count("c", 7)
    outer, inner = tr.spans
    assert tr.counters["c"] == 13
    assert outer["c"] == 1 and inner["c"] == 7


def test_a_tensor_amount_is_read_when_the_block_exits():
    with tracing() as tr:
        with span("outer"):
            with span("inner"):
                profiling.count(("a", "b"), torch.tensor([3, 4]))
            profiling.count("a", torch.tensor(10, dtype=torch.int32))
            # kept as a tensor until the block exits: listed, not yet added
            assert tr.counters["a"] == tr.counters["b"] == 0
            assert "a" in tr.counters and "b" in tr.counters
    outer, inner = tr.spans
    assert (tr.counters["a"], tr.counters["b"]) == (13, 4)
    assert (inner["a"], inner["b"], outer["a"], outer["b"]) == (3, 4, 10, 0)
    assert all(isinstance(v, int) for v in tr.counters.values())


def test_rows_of_amounts_are_summed_when_read():
    with tracing() as tr:
        profiling.count(("a", "b"), torch.tensor([[1, 2], [3, 4], [5, 6]]))
        profiling.count("c", torch.tensor([[7], [8]]))
    assert (tr.counters["a"], tr.counters["b"], tr.counters["c"]) == (9, 12,
                                                                      15)


def test_a_count_needs_one_amount_a_name():
    with tracing():
        with pytest.raises(ValueError, match="2 counts for 3 names"):
            profiling.count(("a", "b", "c"), torch.tensor([1, 2]))
        with pytest.raises(ValueError, match="2 counts for 3 names"):
            profiling.count(("a", "b", "c"), torch.ones(4, 2))
        with pytest.raises(ValueError, match="1 counts for 2 names"):
            profiling.count(("a", "b"), 1)


def test_reading_the_amounts_counts_no_host_sync(monkeypatch):
    """The tensor amounts are read after the sync debug mode and the
    warning hook are restored: a sync warning then is not counted."""
    import warnings

    read = profiling.Trace._resolve

    def resolve(self):
        warnings.warn(profiling.SYNC_WARNING + " (reading the counts)")
        read(self)

    monkeypatch.setattr(profiling.Trace, "_resolve", resolve)
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        with tracing() as tr:
            with span("s"):
                profiling.count("a", torch.tensor(2))
    assert tr.counters["host_syncs"] == 0 and tr.spans[0]["host_syncs"] == 0
    assert tr.counters["a"] == 2
    assert any(str(w.message).startswith(profiling.SYNC_WARNING)
               for w in seen)


def test_one_range_for_each_count():
    """One empty range a call, not one a unit; a call counting several
    names is one range, named by the first."""
    def run():
        with tracing():
            profiling.count("a", torch.tensor(5))
            profiling.count("b", 9)
            profiling.count(("c", "a"), torch.tensor([1, 2]))

    names = [e.name() for e in _kineto(run)
             if e.name().startswith(profiling.PREFIX)]
    assert sorted(names) == ["xtt:a", "xtt:b", "xtt:c"]


def test_the_last_blocks_counters_are_read_after_it():
    with tracing() as tr:
        with tracing() as inner:
            profiling.count("a", torch.tensor(4))
        # an inner block is the outer one: nothing is read before it ends
        assert inner is tr and tr.counters["a"] == 0
    assert profiling.last_trace() is tr and tr.counters["a"] == 4
    with tracing() as other:
        profiling.count("a")
    assert profiling.last_trace() is other and other.counters["a"] == 1


def test_counts_outside_tracing_record_nothing():
    with tracing() as tr:
        pass
    profiling.count("a", 3)
    profiling.count(("a", "b"), torch.tensor([1, 2]))
    assert not profiling.active()
    assert profiling.last_trace() is tr and "a" not in tr.counters
    names = [e.name() for e in _kineto(lambda: profiling.count("a", 3))
             if e.name().startswith(profiling.PREFIX)]
    assert not names


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


def test_percentile_sites_and_the_doyquantile_counter():
    """percentile_doy opens op.doyquantile inside percentiles.doy; on CPU
    tensors the op runs its twin (the gather, then the sort quantile)
    inside it and counts no launch."""
    with tracing() as tr:
        _etccdi(False)
    rec = {s["id"]: s for s in tr.spans}
    (doy,) = [s for s in tr.spans if s["name"] == "percentiles.doy"]
    (op,) = [s for s in tr.spans if s["name"] == "op.doyquantile"]
    assert op["parent"] == doy["id"]
    for name in ("percentiles.gather", "op.quantile"):
        (inner,) = [s for s in tr.spans if s["name"] == name]
        assert inner["parent"] == op["id"]
    assert tr.counters["doyquantile_launches"] == 0
    assert all(s["doyquantile_launches"] == 0 for s in tr.spans)
    assert rec[op["root"]]["name"] == "percentiles.doy"


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
    # one pass a node (50 quantiles and the two end nodes), all in the
    # eqmadjust op's span inside sdba.eqm
    assert tr.counters["eqm_node_passes"] == 52
    (eqm,) = [s for s in tr.spans if s["name"] == "sdba.eqm"]
    (op,) = [s for s in tr.spans if s["name"] == "op.eqmadjust"]
    assert op["parent"] == eqm["id"]
    assert op["eqm_node_passes"] == 52
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
    (op,) = [s for s in tr.spans if s["name"] == "op.eqmadjust"]
    assert op["parent"] == eqm["id"]
    assert op["eqm_node_passes"] == tr.counters["eqm_node_passes"] == 12
    assert "sdba.scaling" not in _names(tr)
    assert "sdba.detrend" not in _names(tr)


def test_ensembles_sites_and_the_betainc_counter(monkeypatch):
    from xclim_tpu_torch.ops import betainc

    steps = []
    numerator = betainc._betainc_numerator

    def counted(it, a, b, x):
        steps.append(it)
        return numerator(it, a, b, x)

    monkeypatch.setattr(betainc, "_betainc_numerator", counted)
    with tracing() as tr:
        _ensemble_calls()
    rec = {s["id"]: s for s in tr.spans}
    names = _names(tr)
    (pct,) = [s for s in tr.spans if s["name"] == "ensembles.percentiles"]
    (rob,) = [s for s in tr.spans if s["name"] == "ensembles.robustness"]
    assert pct["parent"] is None and rob["parent"] is None
    assert rec[next(s["parent"] for s in tr.spans
                    if s["name"] == "op.quantile")] is pct
    # the moments and the t statistic, then one incomplete beta evaluation
    order = [n for n in names if n in ("ensembles.moments",
                                       "ensembles.betainc")]
    assert order == ["ensembles.moments", "ensembles.betainc"]
    kids = [s for s in tr.spans if s["parent"] == rob["id"]]
    assert [s["name"] for s in kids] == order
    # one count a step of the CPU twin's continued fraction, all in the op
    # span inside ensembles.betainc
    (beta,) = [s for s in tr.spans if s["name"] == "ensembles.betainc"]
    (op,) = [s for s in tr.spans if s["name"] == "op.betainc"]
    assert op["parent"] == beta["id"]
    assert steps == list(range(1, len(steps) + 1)) and len(steps) > 1
    assert tr.counters["betainc_terms"] == op["betainc_terms"] \
        == len(steps)
    assert sum(s["betainc_terms"] for s in tr.spans) == len(steps)


def test_betainc_steps_are_ranges_inside_the_betainc_span():
    def run():
        with tracing():
            _ensemble_calls()

    events = _kineto(run)
    (beta,) = [e for e in events if e.name() == "xtt:ensembles.betainc"]
    (rob,) = [e for e in events if e.name() == "xtt:ensembles.robustness"]
    steps = [e for e in events if e.name() == "xtt:betainc_terms"]
    assert steps
    assert rob.start_ns() <= beta.start_ns() <= beta.end_ns() <= rob.end_ns()
    assert all(beta.start_ns() <= e.start_ns() <= e.end_ns()
               <= beta.end_ns() for e in steps)


def test_icclim_suite_sites_and_the_indicator_call_counter():
    with tracing() as tr:
        _icclim_suite()
    names = _names(tr)
    calls = [s for s in tr.spans if s["name"] == "indicator.call"]
    assert len(calls) == tr.counters["indicator_calls"] == 30
    # one count an Indicator.__call__, in its own outermost span
    assert all(s["indicator_calls"] == 1 and s["parent"] is None
               for s in calls)
    assert sum(s["indicator_calls"] for s in tr.spans) == 30
    # CSU, CFD, CDD, CWD; GSL; RX5day
    assert names.count("runlength.runs") == 4
    assert names.count("runlength.season") == 1
    assert names.count("rolling.reduce") == 1
    rec = {s["id"]: s for s in tr.spans}
    for s in tr.spans:
        if s["name"].startswith(("runlength.", "rolling.")):
            assert rec[s["parent"]]["name"] == "indicator.compute"


def _ancestors(span, rec):
    while span["parent"] is not None:
        span = rec[span["parent"]]
        yield span["name"]


@pytest.mark.parametrize("case", ["suite", *sorted(_run_length_calls())])
def test_no_run_length_span_opens_inside_one_it_is_counted_with(case):
    """The metric ``indices.runlength_ms`` sums the device time launched in
    ``runlength.runs`` and ``runlength.season``: an operation inside two
    such spans would count twice, as it would inside two of one name."""
    fn = _icclim_suite if case == "suite" else _run_length_calls()[case]
    with tracing() as tr:
        fn()
    rec = {s["id"]: s for s in tr.spans}
    seen = set()
    for s in tr.spans:
        up = set(_ancestors(s, rec))
        assert s["name"] not in up, s["name"]
        if s["name"].startswith("runlength."):
            assert not {"runlength.runs", "runlength.season"} & up, case
            seen.add(s["name"])
    assert seen


def _op_calls():
    from xclim_tpu_torch.ops import (betainc, bootstrap, eqmadjust, qdmadjust,
                                     segred, spells, winquantile)
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
        "op.betainc": lambda: betainc.betainc(
            torch.abs(af[0]) + 1.0, 0.5, torch.sigmoid(x2[:5])),
        "op.bootstrap": lambda: bootstrap.merge_rank_replaced_year_quantile(
            *tabs, None, None, 1, 0.9, samples=D),
        "op.winquantile": lambda: winquantile.doy_window_quantiles(xg, q, 3),
        "op.eqmadjust": lambda: eqmadjust.eqm_adjust_series(
            x2, table, torch.sort(af, dim=1).values, af),
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


@pytest.mark.parametrize("case", ["bootstrap", "plain", "qdm", "dqm", "eqm",
                                  "ensembles", "icclim"])
def test_outputs_are_bit_equal_with_tracing_on_and_off(case):
    fn = {"bootstrap": lambda: _etccdi(True),
          "plain": lambda: _etccdi(False), "qdm": _qdm, "dqm": _dqm,
          "eqm": _eqm, "ensembles": _ensemble_calls,
          "icclim": _icclim_suite}[case]
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


@pytest.mark.cuda
def test_a_device_amount_is_read_without_a_host_sync_in_the_block():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: host syncs exist only on the card")
    x = torch.ones(1000, device="cuda")
    x.sum().item()                      # warm up outside the trace
    with tracing() as tr:
        with span("s"):
            counts = torch.zeros(2, dtype=torch.int64, device="cuda")
            counts[0] += 6
            counts[1] += 1
            profiling.count(("a", "b"), counts)
    assert (tr.counters["a"], tr.counters["b"]) == (6, 1)
    assert tr.spans[0]["a"] == 6
    assert tr.counters["host_syncs"] == tr.spans[0]["host_syncs"] == 0
