"""The cell ``ens192x448.pct_robust`` at a tiny size on the CPU: a traced run
is correct and its program line holds the ensembles' spans and the
continued fraction's counter; the five readers it adds read a number where
their span, counter or entry ran and nothing where they did not; the
caller's warming and missing cells reach the reference; the reference's
p-value is Student's; the control fails its limits; and two broken paths
are not correct."""

import copy
import json
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType

from perfbench import control, generate, program, roofline, run, spec
from perfbench.callers import ensembles as caller
from perfbench.reference import ensembles as reference
from perfbench.tests.conftest import SEED
from perfbench.tests.test_perfbench_program import TRACE, Ev, rt

CELL = "ens192x448.pct_robust"
SPANS = ("ensembles.percentiles", "ensembles.robustness", "ensembles.moments",
         "ensembles.betainc")


def tiny(bench):
    """The cell's configuration at 4 x 6 cells, all 30 members and the
    year; a quarter of the cells in land masks, so that members missing at
    a cell are drawn at this size too."""
    c = copy.deepcopy(spec.config_of(bench, spec.cell(bench, CELL)))
    c["data"].update(grid=[4, 6], land_mask_share=0.25)
    c["check"]["cells"] = 24
    return c


def test_a_traced_run_is_correct_and_shows_the_spans(bench, cpu, capsys):
    res, lines = run.run_cell(bench, CELL, SEED, 0.2, True, cpu,
                              time.perf_counter(), config=tiny(bench))
    assert res["correct"] is True, lines
    assert set(res["checks"]) == {
        "p10_max_abs_K", "p50_max_abs_K", "p90_max_abs_K",
        "pvals_max_abs_prob", "valid_max_abs_frac", "calls_differing",
        *(f"{k}_outside_frac" for k in reference.INTERVALS)}
    (line,) = [ln for ln in capsys.readouterr().err.splitlines()
               if ln.startswith("program ")]
    p = json.loads(line[len("program "):])
    counts, calls = p["span_counts"], p["calls"]
    assert {k: counts[k] / calls for k in SPANS} == dict.fromkeys(SPANS, 1)
    terms = counts["betainc_terms"] / calls
    assert terms == int(terms) and 1 < terms <= 199
    assert res["metrics"]["betainc.terms_per_call"]["value"] == terms
    # no card: no device time, so the span readers have nothing to read
    for name in ("ensembles.percentiles_ms", "ensembles.betainc_ms",
                 "ensembles.idle_ms", "axisquantile.roofline_pct"):
        assert name not in res["metrics"]


def _reading(with_spans: bool):
    """A made-up call: three kernels, one launched in the percentiles, one
    in the moments and one in the incomplete beta function (or in spans of
    other names), a gap in each of the two outer spans."""
    pct, rob, mom, beta = SPANS if with_spans else ("a.b", "c.d", "e.f",
                                                    "g.h")
    events = [Ev("call", 0, 100), Ev("ensembles.percentiles", 0, 30),
              Ev("ensembles.robustness", 30, 100),
              rt("cudaLaunchKernel", 5, 6, 1),
              rt("cudaLaunchKernel", 35, 36, 2),
              rt("cudaLaunchKernel", 55, 56, 3),
              Ev("k1", 0, 20, DeviceType.CUDA, corr=1),
              Ev("k2", 40, 50, DeviceType.CUDA, corr=2),
              Ev("k3", 60, 100, DeviceType.CUDA, corr=3),
              Ev("xtt:" + pct, 0, 30), Ev("xtt:" + rob, 30, 100),
              Ev("xtt:" + mom, 30, 52), Ev("xtt:" + beta, 52, 100)]
    events += [Ev("xtt:betainc_terms", 57 + i / 10, 57 + i / 10)
               for i in range(7 if with_spans else 0)]
    return program.read_events(events, {"ensembles.percentiles",
                                        "ensembles.robustness"}, 1, TRACE)


READERS = {"ensembles.percentiles_ms": 20e-6, "ensembles.betainc_ms": 40e-6,
           # idle: 20-30 in the percentiles, 30-40 and 50-60 in robustness
           "ensembles.idle_ms": 30e-6, "betainc.terms_per_call": 7.0}


@pytest.mark.parametrize("name", sorted(READERS))
def test_each_new_program_reader(bench, name):
    r = run.metric_reader(name)
    assert r.read(SimpleNamespace(program=_reading(True))) \
        == pytest.approx(READERS[name])
    # a program without the spans, or without tracing, gives nothing
    assert r.read(SimpleNamespace(program=_reading(False))) is None
    assert r.read(SimpleNamespace(program=None)) is None
    (m,) = [m for m in bench["per_layer"] if m["name"] == name]
    assert m["workloads"] == [CELL] and m["moves"] == "cell_days_per_s"


def test_the_axisquantile_roofline_reader(bench):
    r = run.metric_reader("axisquantile.roofline_pct")
    assert r.ENTRY == "xclim_tpu_torch.ops.axisquantile:axis_quantile_small"
    # the cell's call: 30 members of 365 x 192 x 448 in, 3 nodes out
    x = torch.empty(30, 365, 192, 448, device="meta")
    out = torch.empty(3, 365, 192, 448, device="meta")
    nbytes, ops = r.work((x, [0.1, 0.5, 0.9], 0), {}, out)
    assert nbytes == 4 * 33 * 365 * 192 * 448
    b = roofline.bound(nbytes, ops)
    assert b["bound_by"] == "bytes" and round(b["bound_ms"], 3) == 1.237
    calls = [{"ms": 2.0, "bound_ms": 1.2}, {"ms": 2.0, "bound_ms": 1.2}]
    assert r.read(SimpleNamespace(entries={r.ENTRY: calls})) \
        == pytest.approx(60.0)
    assert r.read(SimpleNamespace(entries={})) is None
    (m,) = [m for m in bench["per_layer"]
            if m["name"] == "axisquantile.roofline_pct"]
    assert m["workloads"] == [CELL] and m["source"] == "device_trace"


def test_the_callers_warming_and_missing_cells_are_in_the_inputs(bench, cpu):
    config = tiny(bench)
    state = caller.setup(config, SEED, cpu)
    plain = generate.make(config["data"], SEED, cpu)
    warm, missing = caller.masks(config["data"], SEED, 30)
    got = caller.inputs(state)
    ramp = torch.linspace(0.0, 1.0, 365)[:, None]
    miss = missing.reshape(30, -1)
    for m, (name, x) in enumerate(got.items()):
        want = plain[name].reshape(365, -1) + ramp * float(warm[m])
        want[:, torch.as_tensor(miss[m])] = torch.nan
        assert torch.equal(x.isnan(), want.isnan())
        assert torch.equal(x.nan_to_num(), want.nan_to_num())
    lo, hi = config["data"]["warming_K"]
    assert ((lo <= warm) & (warm <= hi)).all()
    # a cell misses no member, every member, or 1 to 29 of them
    per_cell = miss.sum(axis=0)
    assert (per_cell == 30).any() and (per_cell == 0).any()
    assert ((per_cell > 0) & (per_cell < 30)).any()
    # the ensemble the program is handed stacks the same series
    assert torch.equal(state["ens"].data.nan_to_num(),
                       torch.stack(list(state["raw"].values())).nan_to_num())


def test_the_reference_pvalue_is_students():
    stats = pytest.importorskip("scipy.stats")
    t = torch.tensor([0.0, 1e-4, 0.003, 0.3, 1.0, 1.7, 1.96, 2.5, 4.0, 9.0,
                      -2.0, 40.0], dtype=torch.float64)
    for df in range(1, 201):
        got = reference.t_pvalue(t, torch.full_like(t, float(df)))
        want = 2.0 * stats.t.sf(np.abs(t.numpy()), df)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-9, atol=1e-14)
    # NaN in, NaN out; an infinite t has no tail
    p = reference.t_pvalue(torch.tensor([torch.nan, torch.inf]),
                           torch.tensor([181.0, 181.0]))
    assert torch.isnan(p[0]) and p[1] == 0.0


@pytest.mark.parametrize("seed", [SEED, SEED + 1, SEED + 2])
def test_the_control_fails_every_limit_but_valid(bench, cpu, seed):
    out = control.control(bench, CELL, seed, cpu, config=tiny(bench))
    checks = dict(out["checks"])
    # the control's inputs come from the generator alone, without the
    # caller's missing cells, so every member is valid in both references:
    # valid, an exact count, cannot move with the precision
    assert checks.pop("valid_max_abs_frac")["value"] == 0.0
    assert out["fails"]
    assert all(v["value"] > v["limit"] for v in checks.values()), checks


def _cut_betainc(monkeypatch):
    """The continued fraction cut to 4 terms. At df 181 it reaches float32's
    resolution within 10 to 20 terms: over 256 cells of the cell's inputs a
    cut to 20 terms moves no p-value by more than 4e-6, to 5 terms by
    3.6e-3, within the p-values' limit (which float32's rounding of p near 1
    sets), and to 4 terms by 3.2e-2."""
    from xclim_tpu_torch.ensembles import _robustness

    monkeypatch.setattr(_robustness, "_BETAINC_ITERATIONS", 5)


def _missing_counts_as_valid(monkeypatch):
    from xclim_tpu_torch.ensembles import _robustness

    moments = _robustness._moments

    def never_missing(x, tax):
        n, m, ss, nan = moments(x, tax)
        return n, m, ss, torch.zeros_like(nan)

    monkeypatch.setattr(_robustness, "_moments", never_missing)


@pytest.mark.parametrize("broken,fails", [
    (_cut_betainc, {"pvals_max_abs_prob"}),
    (_missing_counts_as_valid, {"valid_max_abs_frac"})])
def test_a_broken_path_is_not_correct(bench, cpu, monkeypatch, broken,
                                      fails):
    broken(monkeypatch)
    res, lines = run.run_cell(bench, CELL, SEED, 0.2, False, cpu,
                              time.perf_counter(), config=tiny(bench))
    assert res["correct"] is False, lines
    failing = {k for k, v in res["checks"].items() if v["value"] > v["limit"]}
    assert fails <= failing, failing


def test_the_reference_imports_neither_jax_nor_the_port():
    import ast
    import pathlib

    from perfbench.reference import hyndman_fan

    roots = set()
    tree = ast.parse(pathlib.Path(reference.__file__).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            roots.add(node.module.split(".")[0])
    assert roots == {"__future__", "math", "torch", "perfbench"}
    text = pathlib.Path(hyndman_fan.__file__).read_text()   # what it reuses
    assert "xclim_tpu" not in text and "jax" not in text
