#!/usr/bin/env python3
"""Smoke run of the PyTorch port (xclim_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds every target of ``xclim_tpu_torch.ops._build.TARGETS`` (into
``xclim_tpu_torch/_build/``, one nvcc per target, all at once), then runs
the port at the sizes users run (the kernels against their twins at small
shapes are the card tests', ``tests/test_torch_kernels_cuda.py``):

1. prints each kernel's build time, the card's name and power limit;
2. drives the sdba QDM slice at the repo's "QDM 16k" size (128 x 128 cells,
   30 noleap years, day-of-year window 31, 50 quantiles) through
   ``QuantileDeltaMapping.train(...).adjust(...)``, checks that it went
   through the kernels (launch counts) and that the result is right, times
   it, runs EQM once, times each kernel against its twin at the slice's
   shapes, and runs winquantile's stage profile there (each stage's
   result held against its plain expression); then holds winquantile
   against its twin at the benchmark cells' (365, 30, 65536) and times
   it there beside its bound, the twin and the stage profile;
3. runs the same public call on the first 256 cells with CPU tensors (the
   twins) and on the card (the kernels) and compares the outputs;
4. drives the indicator slice ``atmos.tg_mean(tas, freq="MS")`` at the
   repo's "tg_mean 512" size (3650 noleap days x 512 x 512 cells, 3.83 GB
   of float32) with NaN holes, checks its launch counts, values, NaN
   pattern and attributes, times the indicator and the bare index, runs
   ``atmos.tx_max(..., freq="YS")`` once, and times segred against its
   twin at the slice's shape;
5. runs tg_mean on the first 1024 cells with CPU tensors and on the card
   and compares the outputs;
6. drives the percentile slice at the repo's "tx90p bootstrap 4096" size
   (64 x 64 cells, 30 noleap years from 1981-01-01, an AR(1) tasmax):
   ``percentile_doy(tasmax, 5, 90)``, ``atmos.tx90p(..., bootstrap=True)``
   and ``atmos.warm_spell_duration_index(..., bootstrap=True)``, checks
   their launch counts and values, times them, and holds doyquantile
   (percentile_doy's quantiles, value for value), segred (tx90p's
   exceedance sums, plain and 29 replacements x 4096 cells), spells
   (WSDI's condition, 29 replacements x 4096 cells) and the bootstrap
   kernel (one in-base year's 29 replaced-year thresholds at 365 doys x
   4096 cells, K 23, bit for bit) against their twins at the bootstrap's
   own inputs;
7. runs the same calls on the first cells with CPU tensors and on the card
   and compares the outputs;
8. drives the ensembles slice at bench's "ensembles 192x448" size (30
   members x 365 noleap days x 192 x 448 cells, 3.77 GB of float32) with
   planted NaN cells: ``create_ensemble``, ``ensemble_percentiles(ens,
   [10, 50, 90])`` and ``robustness_fractions(fut, hist, test="ttest")``,
   checks their launch counts and values (the benchmark's cell
   ``ens192x448.pct_robust`` times them), holds the axisquantile kernel
   against its twin at the call's own input, and times the kernel, the
   twin and ``torch.nanquantile`` on the same input; holds the betainc
   kernel against its twin at the t-test's own arguments (p-values of
   30 x 192 x 448 elements) and times both;
9. runs the same two calls on the first 1024 cells with CPU tensors and on
   the card and compares the outputs;
10. drives config 2 at bench's "spells" sizes (448 x 448 and 100 x 100
    cells x 3650 noleap days, tasmax N(290, 8) and tasmin N(280, 8) K):
    ``atmos.tx_days_above(tasmax, thresh="25 degC", freq="YS")``,
    ``atmos.heat_wave_frequency(tasmin, tasmax, ...)`` and the bare
    indices, checks their launch counts and their values against per-year
    expressions, times them (seconds, cell-days/s, peak memory), times
    threshold_count's two routes (spells; compare + segred) side by side,
    holds spells against its twin at the heat-wave condition and profiles
    the pair;
11. runs config 2 and its neighbours (hot spells, frost days, seasons,
    degree days, find_events) on a 32 x 32 crop with CPU tensors and on
    the card and compares the outputs;
12. drives DQM at config 4's width (``DetrendedQuantileMapping.train(ref,
    hist, group=Grouper("time.dayofyear", 31), nquantiles=50,
    kind="+").adjust(sim)``, 128 x 128 cells, 30 noleap years, QDM's series
    with +0.03 K a year added to sim), checks that the train launched
    winquantile twice and the adjust eqmadjust once, and no twin, that scen
    is finite where sim is and keeps each cell's trend, holds winquantile
    against its twin at the scaled hist and eqmadjust against its twin at
    sim and the trained state (timed), times train and adjust and profiles
    the adjust;
13. runs DQM on a 32 x 32 crop with CPU tensors and on the card and
    compares af, hist_q, scaling and scen;
14. runs the rest of sdba once each at the sizes users run and holds each
    against its CPU run on a crop: Scaling and LOCI (time.month) on a
    precipitation series with dry days and ExtremeValues on a jittered QDM
    doy first pass, at 16384 cells; properties (mean, quantile, acf,
    spell_length_distribution, return_value) and measures (bias, rmse) on
    DQM's scen; ``stats.fit(annual maxima, "genextreme")`` by the batched
    BFGS over 16384 cells; ``npdf_transform`` (3 x 10950 days, 20
    rotations); OTC and dOTC (+ and *) at 2048 points x 3 variables;
15. drives bench.py's fused 10-indicator chain (bench.py:542-600: TG_MEAN,
    TX_DAYS_ABOVE, FROST_DAYS, ICE_DAYS, the three degree days,
    HEAT_WAVE_INDEX, CDD and PRCPTOT through the registry and
    ``climjit_chain``) at its two rows, 320 x 320 and 100 x 100 cells x
    3650 noleap days: each step's launch counts and values against plain
    per-year expressions, indicator-cell-days/s, TG_MEAN alone and the
    marginal ms per indicator, peak memory, a profile, and segred and
    spells against their twins at the chain's inputs;
16. runs the chain on a 32 x 32 crop with CPU tensors and on the card and
    compares the outputs;
17. runs each new index module once at a size users run, against its CPU
    run on a crop: SPI-3/SPEI-3, rain_season, dryness_index, the ANUCLIM
    quarters, aridity, the antecedent precipitation index, every PET
    method, UTCI with MRT, the agroclimatic temperature indicators and the
    converter branches of _multivariate at 128 x 128 cells x 30 years; the
    chill models and max_pr_intensity on a year of hours at 16384 cells
    (the chill portions held to a float64 replay on a 256-cell crop); the
    jet stream on 30 years x 64 latitudes. Each call's time is the median
    of 3 after a warm-up;
18. drives the fire-weather slice at 16384 cells x 30 noleap years
    (tas, pr with 45-55 % dry days, hurs, sfcWind; tasmax = tas + 6 K):
    ``atmos.cffwis`` always on (the median of 3), with the WF93 season and
    overwintering and with a dry start (one timed call each),
    ``atmos.dc`` (WF93, overwintering) and ``atmos.dmc``, which run their
    one code, the kbdi -> df -> ffdi chain and ``atmos.fire_season`` (the
    median of 3), each after a warm-up on the first year: seconds, peak
    memory above the inputs, and a profiled run's kernel launches, kernel
    time and idle share. On a 256-cell crop the card's CFFWIS and the
    CPU's are each held to a float64 replay of their own days
    (``xclim_tpu_torch.testing.check_cffwis``), and DC, FFMC and ISI to
    each other (the outputs that read DMC may part where the two devices'
    DMC took two sides of b's jump at 33 or 65: their difference is
    printed); ``atmos.dc`` and ``atmos.dmc`` equal the code of the card's
    CFFWIS run, DC holds to the CPU run; KBDI holds to the CPU run, DF and
    FFDI to the CPU on the card's own KBDI and DF, the fire season is
    equal;
19. runs every land (snow, streamflow), seaIce and generic indicator once
    at a size users run (the snow and generic ones at 128 x 128 cells x 30
    years, streamflow at 4096 stations, sea-ice extent and area on 180 x
    360 cells x 30 years): seconds, segred and spells launches (no twin on
    the card), and the outputs against the CPU run on a crop;
20. runs the calendar's array operations at 16384 cells x 60 years
    (``convert_calendar`` noleap -> 360_day and back and standard ->
    noleap, ``stack_periods(window=30, stride=10)`` and
    ``unstack_periods``, ``mask_between_doys``, ``select_time`` by season,
    month and doy bounds), each the median of 3 after a warm-up and equal
    to the CPU run on a 256-cell crop;
21. runs each of the 131 indicators of the YAML modules icclim, anuclim
    and cf at 128 x 128 cells x 30 noleap years with every variable they
    read (tas, tasmax, tasmin, pr, snd, hurs, psl, sfcWind, wsgsmax, sund;
    0.72 GB each) and the percentile inputs from ``percentile_doy`` over
    the series: seconds (one warm-up, one timed run), segred and spells
    launches, the outputs against the CPU run on an 8 x 8 crop, an entry
    that only renames a core indicator equal to it, and the five entries
    that refuse such inputs in the JAX package refusing them on both
    devices alike;
22. writes a classic NetCDF file of tas, tasmax, tasmin and pr at 16384
    cells x 10950 days (2.87 GB, scipy, a temporary directory), reads it
    with the native reader (counted in ``xclim_tpu_torch.io.netcdf.opens``;
    values equal to what was written), moves it to the card and runs the
    command line's pipeline (``xclim_tpu_torch.cli.Pipeline``: the data
    flags and ten icclim indicators) plain and ``--fused`` (equal to each
    other, the indicators on a crop equal to the CPU pipeline), timing the
    read, host to card, compute and write apart; then the pipeline once
    more from the file, and click's ``main`` where click is installed
    (the write needs h5py; each of PyYAML, click and h5py is printed as
    installed or missing);
23. at the same size, ``data_flags`` for tas, tasmax, tasmin and pr and
    ``ecad_compliant`` (each flag on a crop equal to the CPU run),
    ``spatial_analogs`` of one cell's 30 annual samples x 3 indicators
    against the 16384 cells with each metric (the crop held to the CPU's
    float32 and float64 runs), ``sharded_jit(atmos.tg_mean)`` on the (1, 1)
    mesh equal to the plain call, ``utils.profiling.profile``'s trace (in
    a fresh process) and ``timed``'s synced seconds.

Each phase prints its wall seconds (``[wall]``). Its launch counts
(``_counts``) hold ``launches`` and ``twin_calls`` of the op module of
every build target, ``bootstrap`` included.

Each kernel's record carries its bound (``bound_ms``, from
``perfbench/roofline.py``: the larger of its bytes over 3.35 TB/s and its
operations over 67 TFLOP/s, the H100 SXM's published peaks, computed from
this run's inputs) and, where one PyTorch call computes the same
function, that call's time (``library_ms``).

Every phase raises on failure. The last two lines are a JSON object with
one entry per kernel and the result line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Without a CUDA device it exits with status 2 and prints no result.

    PYTHONPATH=<checkout> python3 -P chip_smoke.py --kernel-times

prints one JSON line of the winquantile, spells, qdmadjust,
axisquantile and betainc times at this script's shapes (``kernel_times``;
betainc beside its twin, and the twin alone where the package has no
``ops.betainc``) for the
package of ``<checkout>`` (``-P`` keeps this script's own directory off
the module path), and nothing else: run it for two checkouts in turns
within one call to compare them on one card.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

RTOL = 1e-6     # SURVEY.md §6: float results agree within 1e-6
ATOL = 1e-6     # for values near zero (adjustment factors)
NQ = 50
WINDOW = 31
YEARS = 30
SIDE = 128      # 128 x 128 = 16384 cells
SMALL_CELLS = 1024
CPU_CELLS = 256
SEED = 1981
TG_DAYS = 3650  # 10 noleap years from 2000-01-01
TG_SIDE = 512   # 512 x 512 = 262144 cells
TG_CPU_CELLS = 1024
PCT_SIDE = 64   # 64 x 64 = 4096 cells: bench.py's tx90p bootstrap size
PCT_YEARS = 30
PCT_CPU_CELLS = 64    # one grid row: the CPU twins of a 30-year bootstrap are slow
PHI = 0.8       # AR(1) coefficient of the tasmax anomaly
SPELL_DAYS = 10950
ENS_MEMBERS = 30
ENS_DAYS = 365      # noleap days from 2000-01-01
ENS_LAT, ENS_LON = 192, 448   # bench.py's "ensembles 192x448"
ENS_CPU = (4, 256)  # lat x lon: the first 1024 cells
ENS_VALUES = [10, 50, 90]
P_RTOL = 1e-3       # p-values: lgamma, exp and log round differently
P_ATOL = 1e-6       # on the CPU and the card (tests/test_torch_ensembles.py)
P_NEAR_ONE = 3e-3   # p >= 0.5: x = df / (df + t^2) rounds to 1 - k ulp
# betainc kernel vs twin: the twin steps converged elements on until the
# whole call has converged, its h drifting by up to one ulp a step
BETAINC_DRIFT = 198 * 2.0**-23
def _log(*args):
    print(*args, flush=True)


def _sort_compares(n):
    """Comparisons a comparison sort needs for columns of n valid
    values (a tensor of counts): sum of n * log2(n)."""
    import torch

    n = n.double()
    return float(torch.where(n > 1, n * torch.log2(n.clamp(min=1)), 0.0).sum())


def _compare(name, got, ref, rtol=RTOL, atol=ATOL) -> float:
    """Max abs error of got vs ref; raises on a NaN-pattern or tolerance
    mismatch."""
    import torch

    got = got.float().cpu()
    ref = ref.float().cpu()
    if got.shape != ref.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != "
                             f"{tuple(ref.shape)}")
    gn, rn = torch.isnan(got), torch.isnan(ref)
    if not torch.equal(gn, rn):
        raise AssertionError(f"{name}: NaN patterns differ "
                             f"({int((gn != rn).sum())} elements)")
    ok = ~rn
    err = (got - ref).abs()[ok]
    bound = atol + rtol * ref.abs()[ok]
    if err.numel() and bool((err > bound).any()):
        raise AssertionError(f"{name}: {int((err > bound).sum())} elements "
                             f"beyond atol={atol} rtol={rtol}, max abs err "
                             f"{float(err.max())}")
    return float(err.max()) if err.numel() else 0.0


def _cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of fn() over reps runs after one warm-up, by CUDA
    events."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def _lanes(gen, n_doy, Y, C, device, doy366_sparse=False):
    """(n_doy, Y, C) K-scale doy slices: lanes c % 3 == 0 fully valid, 1
    partly missing (15 %), 2 all missing."""
    import torch

    x = torch.randn((n_doy, Y, C), generator=gen, device=device) * 5.0 + 285.0
    lane = torch.arange(C, device=device) % 3
    holes = torch.rand((n_doy, Y, C), generator=gen, device=device) < 0.15
    x = torch.where(holes & (lane == 1), torch.nan, x)
    x = torch.where(lane == 2, torch.nan, x)
    if doy366_sparse:
        # standard calendar: doy 366 exists only in the leap years
        leap = torch.zeros(Y, dtype=torch.bool, device=device)
        leap[3::4] = True
        x[365] = torch.where(leap[:, None], x[365], torch.nan)
    return x


#: winquantile at 1024 cells, (n_doy, Y, C), window, input: the sliding
#: kernel's paths, register sort at the chunk starts (w31 and w5 x 30
#: years), shared-memory sort (w61 x 30 = 1830 and w31 x 60 = 1860
#: samples), a sparse doy 366 and values tied at 0.5 K
WQ_CASES = (((365, YEARS, SMALL_CELLS), WINDOW, "plain"),
            ((366, YEARS, SMALL_CELLS), 5, "sparse366"),
            ((365, YEARS, SMALL_CELLS), 61, "plain"),
            ((365, 2 * YEARS, SMALL_CELLS), WINDOW, "plain"),
            ((365, YEARS, SMALL_CELLS), WINDOW, "tied"))


def _wq_input(gen, shape, kind, device):
    import torch

    x = _lanes(gen, *shape, device, doy366_sparse=kind == "sparse366")
    return torch.round(x * 2.0) / 2.0 if kind == "tied" else x


#: qdmadjust's doy entry at (366, Y, SMALL_CELLS): Y over the four register
#: widths, 2 and 52 nodes (factor tile in shared memory) and 500 (factors
#: from global memory), kind "+" or "*" by the parity of Y + nq
QDM_CASES = tuple((Y, nq) for Y in (1, 7, 30, 33, 64) for nq in (2, 52, 500))


def _qdm_nodes(nq):
    import numpy as np

    from xclim_tpu_torch.sdba.utils import equally_spaced_nodes

    if nq == 2:
        return np.asarray([1e-4, 1.0 - 1e-4], np.float32)
    return equally_spaced_nodes(nq - 2).astype(np.float32)


def _qdm_cases(gen, device):
    """(label, (xd, af, q, kind)) of the QDM_CASES: lanes as _lanes makes
    them with a sparse doy 366, every eighth cell tied at 0.5 K."""
    import torch

    for Y, nq in QDM_CASES:
        kind = "*" if (Y + nq) % 2 else "+"
        x = _lanes(gen, 366, Y, SMALL_CELLS, device, doy366_sparse=True)
        x[:, :, 3::8] = torch.round(x[:, :, 3::8] * 2.0) / 2.0
        af = torch.sort(torch.randn((366, nq, SMALL_CELLS), generator=gen,
                                    device=device), dim=1).values
        if kind == "*":
            af = 1.0 + 0.01 * af
        yield f"Y{Y} nq{nq} {kind}", (x, af, _qdm_nodes(nq), kind)


def _series(device, cells_side):
    """ref N(285, 5), hist N(287, 6), sim N(289, 6) in K on a (time, lat,
    lon) grid, 30 noleap years from 1981-01-01, from one seeded generator."""
    import torch

    from xclim_tpu_torch.core.calendar import date_range
    from xclim_tpu_torch.core.dataarray import ClimArray

    t = date_range("1981-01-01", periods=YEARS * 365, freq="D",
                   calendar="noleap")
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    shape = (len(t), cells_side[0], cells_side[1])
    coords = {"time": t, "lat": list(range(shape[1])),
              "lon": list(range(shape[2]))}
    out = {}
    for name, mu, sd in (("ref", 285.0, 5.0), ("hist", 287.0, 6.0),
                         ("sim", 289.0, 6.0)):
        data = torch.randn(shape, generator=gen, device=device) * sd + mu
        out[name] = ClimArray(data, ("time", "lat", "lon"), coords,
                              {"units": "K"}, name)
    return out


def _qdm_train(series):
    from xclim_tpu_torch.sdba import Grouper, QuantileDeltaMapping

    return QuantileDeltaMapping.train(series["ref"], series["hist"],
                                      group=Grouper("time.dayofyear", WINDOW),
                                      nquantiles=NQ, kind="+")


def _qdm(series):
    adj = _qdm_train(series)
    return adj, adj.adjust(series["sim"])


def _ops():
    """The op module of each build target that has one (the variants
    build a source again and have none)."""
    import importlib

    from xclim_tpu_torch.ops import _build

    return {t: importlib.import_module(f"xclim_tpu_torch.ops.{t}")
            for t in _build.TARGETS if t not in _build.VARIANTS}


#: counters besides launches and twin_calls: key -> (op, attribute)
EXTRA_COUNTS = {"winquantile_stages": ("winquantile", "stage_launches"),
                "winquantile_global": ("winquantile", "global_launches"),
                "qdmadjust_af_shared": ("qdmadjust", "af_shared_launches"),
                "qdmadjust_af_global": ("qdmadjust", "af_global_launches"),
                "axisquantile_staged": ("axisquantile", "staged_launches"),
                "axisquantile_direct": ("axisquantile", "direct_launches"),
                "bootstrap_shared": ("bootstrap", "shared_launches"),
                "bootstrap_global": ("bootstrap", "global_launches"),
                "eqmadjust_shared": ("eqmadjust", "shared_launches"),
                "eqmadjust_global": ("eqmadjust", "global_launches")}


def _counts():
    out = {}
    for name, mod in _ops().items():
        out[name] = mod.launches
        out[f"{name}_twin"] = mod.twin_calls
    for key, (op, attr) in EXTRA_COUNTS.items():
        out[key] = getattr(_ops()[op], attr)
    return out


def _reset_counts():
    for mod in _ops().values():
        mod.launches = mod.twin_calls = 0
    for op, attr in EXTRA_COUNTS.values():
        setattr(_ops()[op], attr, 0)


def _count_calls(targets, run):
    """(calls of each module.name in targets made by run(), run()'s
    result); the calls themselves go through."""
    counts, saved = {}, []
    for mod, name in targets:
        key = f"{mod.__name__}.{name}"
        fn = getattr(mod, name)
        counts[key] = 0
        saved.append((mod, name, fn))

        def counted(*args, _fn=fn, _key=key, **kwargs):
            counts[_key] += 1
            return _fn(*args, **kwargs)
        setattr(mod, name, counted)
    try:
        result = run()
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    return counts, result


#: the benchmark cells' winquantile shape: (365, 30, WQ_CELLS), window 31
WQ_CELLS = 65536


def _winquantile_at(cells, q, device, card, record):
    """winquantile at (365, YEARS, cells) window WINDOW on the _lanes
    slices: held value for value against its twin, timed beside the twin,
    its bound (bytes) and the stage profile; kept in record["winquantile"]
    ["at_cells"]."""
    import torch

    from perfbench import roofline
    from xclim_tpu_torch.ops import winquantile
    from xclim_tpu_torch.tools.prof_winquantile import stage_times

    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    x = _lanes(gen, 365, YEARS, cells, device)
    got = winquantile.doy_window_quantiles(x, q, WINDOW)
    err = _compare(f"winquantile{tuple(x.shape)}", got,
                   winquantile.doy_window_quantiles_plain(x, q, WINDOW),
                   rtol=0.0, atol=0.0)
    del got
    ms = _cuda_ms(lambda: winquantile.doy_window_quantiles(x, q, WINDOW), 3)
    pms = _cuda_ms(lambda: winquantile.doy_window_quantiles_plain(
        x, q, WINDOW), 1)
    nodes = 365 * len(q) * cells
    bound = roofline.bound((x.numel() + nodes) * 4, 4 * nodes)
    stage_ms = stage_times(x, q, WINDOW, reps=3)
    record["winquantile"]["at_cells"][f"{cells}"] = {
        "ms": ms, "plain_ms": pms, "bound_ms": bound["bound_ms"],
        "stage_ms": stage_ms, "max_abs_err": err}
    _log(f"[kernel vs twin] winquantile {tuple(x.shape)} window={WINDOW} "
         f"({winquantile.instance(WINDOW, YEARS)} instance) on {card}: "
         f"max_abs_err={err} (value-equal) kernel_ms={ms:.3f} "
         f"twin_ms={pms:.3f} bound_ms={bound['bound_ms']:.4f} stages "
         f"{json.dumps({k: round(v, 4) for k, v in stage_ms.items()})} ms")
    del x
    torch.cuda.empty_cache()


def phase_slice(device, card, record):
    import torch

    from perfbench import roofline
    from xclim_tpu_torch.ops import qdmadjust, winquantile
    from xclim_tpu_torch.sdba import (
        EmpiricalQuantileMapping,
        Grouper,
        QuantileDeltaMapping,
    )
    from xclim_tpu_torch.sdba import adjustment
    from xclim_tpu_torch.sdba import utils as sdba_utils
    from xclim_tpu_torch.sdba.utils import gather_doy_slices, gather_groups
    from xclim_tpu_torch.tools.prof_winquantile import stage_times

    series = _series(device, (SIDE, SIDE))
    T = series["sim"].shape[0]
    cells = SIDE * SIDE
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # the main path's run: counts from zero, read right after. The adjust
    # hands the series and its group table to the qdmadjust op: no group
    # gather and no scatter of its own
    _reset_counts()
    adj = _qdm_train(series)
    calls, out = _count_calls(
        [(qdmadjust, "qdm_adjust_series"), (qdmadjust, "qdm_adjust_doy"),
         (adjustment, "gather_groups"), (sdba_utils, "gather_groups")],
        lambda: adj.adjust(series["sim"]))
    torch.cuda.synchronize()
    counts = _counts()
    _log(f"[slice] launch counts of one QDM train+adjust at {cells} cells: "
         f"{json.dumps(counts)}; calls made by the adjust: "
         f"{json.dumps(calls)}")
    zero = {k: 0 for k in counts}
    if counts != dict(zero, winquantile=2, qdmadjust=1,
                      qdmadjust_af_shared=1):
        raise AssertionError(f"main path did not run on the kernels: {counts}")
    if calls != {"xclim_tpu_torch.ops.qdmadjust.qdm_adjust_series": 1,
                 "xclim_tpu_torch.ops.qdmadjust.qdm_adjust_doy": 0,
                 "xclim_tpu_torch.sdba.adjustment.gather_groups": 0,
                 "xclim_tpu_torch.sdba.utils.gather_groups": 0}:
        raise AssertionError(f"QDM adjust did not read through its table: "
                             f"{calls}")
    record["winquantile"]["launches"] = counts["winquantile"]
    record["qdmadjust"]["launches"] = counts["qdmadjust"]
    record["winquantile"]["paths"]["qdm train"] = counts["winquantile"]
    record["qdmadjust"]["paths"]["qdm adjust"] = counts["qdmadjust"]

    # right answer by the repo's own means: shape, finiteness, and the QDM
    # mean shift sim + (ref - hist) = 289 + (285 - 287) = 287 K. The ranks
    # r/30 reach 1 but not 0, so the top node's factor (-2 - z_max K, with
    # sd 5 vs 6) weighs 1/30 more: the output mean sits ~0.1 K below 287.
    # The mean factor over the symmetric nodes is -2 K.
    if tuple(out.shape) != (T, SIDE, SIDE) or out.data.device != device:
        raise AssertionError(f"output {tuple(out.shape)} on {out.data.device}")
    if not bool(torch.isfinite(out.data).all()):
        raise AssertionError("non-finite adjusted values")
    mean = float(out.data.double().mean())
    af_mean = float(adj.ds["af"].double().mean())
    _log(f"[slice] adjusted mean {mean:.4f} K (expect ~287), af mean "
         f"{af_mean:.4f} K (expect ~-2), units {out.attrs['units']}")
    if abs(mean - 287.0) > 0.3 or abs(af_mean + 2.0) > 0.1:
        raise AssertionError("QDM mean shift off")
    peak = torch.cuda.max_memory_allocated() / 2**30

    train_s, adjust_s = [], []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        adj = QuantileDeltaMapping.train(
            series["ref"], series["hist"],
            group=Grouper("time.dayofyear", WINDOW), nquantiles=NQ, kind="+")
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        adj.adjust(series["sim"])
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        train_s.append(t1 - t0)
        adjust_s.append(t2 - t1)
    tr, ad = statistics.median(train_s), statistics.median(adjust_s)
    rate = T * cells / (tr + ad)
    _log(f"[slice] QDM doy w{WINDOW} nq{NQ} {cells} cells {YEARS}y on {card}: "
         f"train {tr:.4f} s, adjust {ad:.4f} s (median of 3 after a warm-up; "
         f"train runs {[round(v, 4) for v in train_s]}, adjust runs "
         f"{[round(v, 4) for v in adjust_s]}), {rate:.1f} cell-days/s, "
         f"peak device memory {peak:.2f} GiB")

    before = _counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eqm = EmpiricalQuantileMapping.train(
        series["ref"], series["hist"], group=Grouper("time.dayofyear", WINDOW),
        nquantiles=NQ, kind="+")
    eout = eqm.adjust(series["sim"])
    torch.cuda.synchronize()
    eqm_s = time.perf_counter() - t0
    after = _counts()
    if (after["winquantile"] - before["winquantile"] != 2
            or after["winquantile_twin"] != before["winquantile_twin"]):
        raise AssertionError(f"EQM train missed the kernel: {before} -> {after}")
    if (after["eqmadjust"] - before["eqmadjust"] != 1
            or after["eqmadjust_twin"] != before["eqmadjust_twin"]):
        raise AssertionError(f"EQM adjust missed the kernel: {before} -> "
                             f"{after}")
    if not bool(torch.isfinite(eout.data).all()):
        raise AssertionError("non-finite EQM output")
    _log(f"[slice] EQM train+adjust {cells} cells: {eqm_s:.4f} s (one run), "
         f"adjusted mean {float(eout.data.double().mean()):.4f} K")

    # each kernel against its twin at the slice's own shapes and inputs
    xf = series["ref"].data
    table = Grouper("time.dayofyear", WINDOW).device_doy_table(
        series["ref"].time, device)
    xd = gather_doy_slices(xf, table).reshape(table.shape[0], table.shape[1],
                                              -1)
    q = adj.ds["quantiles"].astype("float32")
    got = winquantile.doy_window_quantiles(xd, q, WINDOW)
    ref = winquantile.doy_window_quantiles_plain(xd, q, WINDOW)
    err = _compare(f"winquantile{tuple(xd.shape)}", got, ref, rtol=0.0,
                   atol=0.0)
    ms = _cuda_ms(lambda: winquantile.doy_window_quantiles(xd, q, WINDOW), 3)
    pms = _cuda_ms(lambda: winquantile.doy_window_quantiles_plain(
        xd, q, WINDOW), 1)
    # bound: the slices read once, the nodes written once. The function
    # needs only nq order statistics of each window, and neighbouring
    # windows share all but two of their slices: an order-statistic tree
    # that slides with the window (one slice in, one out, nq ranks read,
    # log2(930) = 10 steps each) needs ~7 G operations here, under the
    # bytes. Counted: the interpolation, 4 operations a node
    n_doy, Y, C = xd.shape
    nodes = n_doy * len(q) * C
    record["winquantile"].update(
        max_abs_err=max(record["winquantile"]["max_abs_err"], err), ms=ms,
        plain_ms=pms, **roofline.bound((xd.numel() + nodes) * 4, 4 * nodes))
    _log(f"[kernel vs twin] winquantile {tuple(xd.shape)} window={WINDOW} "
         f"(slice shape, {winquantile.doy_chunks(n_doy, C, WINDOW, Y)} doy "
         f"chunks) on {card}: max_abs_err={err} (value-equal) "
         f"kernel_ms={ms:.3f} twin_ms={pms:.3f} "
         f"bound_ms={record['winquantile']['bound_ms']:.4f}")

    # the stage profile: the same kernel stopped after each stage, each
    # stage's result held against its plain expression (the last against
    # the twin's quantiles above)
    serr = 0.0
    for stage, name in enumerate(winquantile.STAGES):
        sgot = winquantile.doy_window_stage(xd, q, WINDOW, stage)
        torch.cuda.synchronize()
        sref = (ref if stage == 2
                else winquantile.stage_plain(xd, q, WINDOW, stage))
        serr = max(serr, _compare(f"winquantile stage {name}", sgot, sref,
                                  rtol=0.0, atol=0.0))
        del sgot, sref
    stage_ms = stage_times(xd, q, WINDOW, reps=3)
    record["winquantile_stages"].update(
        max_abs_err=serr, ms=stage_ms["full"], plain_ms=pms,
        stage_ms=stage_ms,
        **{k: record["winquantile"][k] for k in ("bound_ms", "bound_by")})
    _log(f"[winquantile stages] {tuple(xd.shape)} window={WINDOW} on {card}:"
         f" {json.dumps({k: round(v, 4) for k, v in stage_ms.items()})} ms "
         f"(loads (+ presort where the instance has one), + sorts and "
         f"slides, + node selection); each stage equal to its plain "
         f"expression (max_abs_err={serr})")
    del got, ref
    record["winquantile"]["at_cells"] = {
        f"{C}": {"ms": ms, "plain_ms": pms,
                 "bound_ms": record["winquantile"]["bound_ms"],
                 "stage_ms": stage_ms}}
    _winquantile_at(WQ_CELLS, q, device, card, record)

    # qdmadjust's two entries against their twins at the slice's own
    # inputs: the series through its adjust table (the main path), and the
    # doy slices gathered from it
    adj_table = Grouper("time.dayofyear", WINDOW).device_adjust_table(
        series["sim"].time, device)[0]
    xf2 = series["sim"].data.reshape(T, -1)
    sd = gather_groups(xf2, adj_table)
    af = adj.ds["af"].reshape(adj.ds["af"].shape[0], adj.ds["af"].shape[1], -1)
    entries = {
        "qdm_adjust_series": (
            lambda: qdmadjust.qdm_adjust_series(xf2, adj_table, af, q, "+"),
            lambda: qdmadjust.qdm_adjust_series_plain(xf2, adj_table, af, q,
                                                      "+")),
        "qdm_adjust_doy": (
            lambda: qdmadjust.qdm_adjust_doy(sd, af, q, "+"),
            lambda: qdmadjust.qdm_adjust_doy_plain(sd, af, q, "+"))}
    ms, pms = {}, {}
    for name, (kernel, plain) in entries.items():
        got = kernel()
        torch.cuda.synchronize()
        err = _compare(f"qdmadjust {name} at the slice", got, plain(),
                       rtol=0.0, atol=0.0)
        record["qdmadjust"]["max_abs_err"] = max(
            record["qdmadjust"]["max_abs_err"], err)
        del got
        ms[name] = _cuda_ms(kernel, 10)
        pms[name] = _cuda_ms(plain, 2)
    # bound: the series and af read once, the result written once (the
    # table's 44 KB besides); operations: the rank of each valid value
    # among its group's (n_valid^2 compares)
    nv = (~torch.isnan(sd)).sum(dim=1).double()
    record["qdmadjust"].update(
        ms=ms["qdm_adjust_series"], plain_ms=pms["qdm_adjust_series"],
        entries_ms=ms, entries_plain_ms=pms,
        **roofline.bound((2 * xf2.numel() + af.numel()
                          + adj_table.numel()) * 4, float((nv * nv).sum())))
    _log(f"[kernel vs twin] qdmadjust at the slice: series {tuple(xf2.shape)}"
         f" through a {tuple(adj_table.shape)} table, and doy slices "
         f"{tuple(sd.shape)}: value-equal; kernel_ms "
         f"{json.dumps({k: round(v, 4) for k, v in ms.items()})} twin_ms "
         f"{json.dumps({k: round(v, 4) for k, v in pms.items()})} bound_ms="
         f"{record['qdmadjust']['bound_ms']:.4f}")
    return series


def phase_cpu_vs_card(full):
    """The public call on the first 256 cells of the slice's series: CPU
    tensors (twins) vs the card (kernels)."""
    import torch

    rows = CPU_CELLS // SIDE
    series = {k: v.isel(lat=slice(0, rows)) for k, v in full.items()}
    cpu = {k: v.to("cpu") for k, v in series.items()}
    before = _counts()
    adj_c, out_c = _qdm(cpu)
    adj_g, out_g = _qdm(series)
    torch.cuda.synchronize()
    after = _counts()
    if (after["winquantile_twin"] - before["winquantile_twin"] != 2
            or after["qdmadjust_twin"] - before["qdmadjust_twin"] != 1
            or after["winquantile"] - before["winquantile"] != 2
            or after["qdmadjust"] - before["qdmadjust"] != 1):
        raise AssertionError(f"CPU run must use the twins, the card the "
                             f"kernels: {before} -> {after}")
    # hist_q: the same sort and f32 op sequence on both devices
    e1 = _compare("hist_q cpu vs card", adj_g.ds["hist_q"], adj_c.ds["hist_q"])
    # af = ref_q - hist_q: absolute error of two ~290 K quantiles
    e2 = _compare("af cpu vs card", adj_g.ds["af"], adj_c.ds["af"],
                  rtol=0.0, atol=1e-4)
    e3 = _compare("QDM output cpu vs card", out_g.data, out_c.data)
    _log(f"[cpu twins vs card kernels] QDM {CPU_CELLS} cells: hist_q "
         f"max_abs_err={e1} af max_abs_err={e2} output max_abs_err={e3}")


#: NaN holes of the tg_mean slice: (lat, lon, first day, end day)
TG_HOLES = ((0, 0, 400, 410), (0, 1, 0, TG_DAYS), (0, 2, 0, 1),
            (1, 5, 1000, 1001), (5, 7, TG_DAYS - 1, TG_DAYS),
            (TG_SIDE - 1, TG_SIDE - 1, 365, 730))


def _tas(device):
    """tas (3650, 512, 512) float32 K, N(285, 5) from a seeded generator, 10
    noleap years from 2000-01-01, with the holes of TG_HOLES."""
    import numpy as np
    import torch

    from xclim_tpu_torch.core.calendar import date_range
    from xclim_tpu_torch.core.dataarray import ClimArray

    t = date_range("2000-01-01", periods=TG_DAYS, freq="D", calendar="noleap")
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    data = torch.randn((TG_DAYS, TG_SIDE, TG_SIDE), generator=gen,
                       device=device)
    data.mul_(5.0).add_(285.0)
    for i, j, t0, t1 in TG_HOLES:
        data[t0:t1, i, j] = torch.nan
    coords = {"time": t, "lat": np.arange(TG_SIDE), "lon": np.arange(TG_SIDE)}
    return ClimArray(data, ("time", "lat", "lon"), coords,
                     {"units": "K", "standard_name": "air_temperature",
                      "cell_methods": "time: mean"}, "tas")


def _expected_nan(spec):
    """(nseg, 512, 512) bool: the periods that TG_HOLES leave incomplete."""
    import torch

    nan = torch.zeros((spec.nseg, TG_SIDE, TG_SIDE), dtype=torch.bool)
    for i, j, t0, t1 in TG_HOLES:
        nan[sorted(set(spec.seg_id[t0:t1].tolist())), i, j] = True
    return nan


def _timed(fn, reps=3):
    """Host seconds of fn() after one warm-up, each run ended by a
    synchronize: (median, runs)."""
    import torch

    fn()
    runs = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        runs.append(time.perf_counter() - t0)
    return statistics.median(runs), runs


def _check_resampled(name, out, spec, device, lo, hi):
    import torch

    shape = (spec.nseg, TG_SIDE, TG_SIDE)
    if tuple(out.shape) != shape or out.data.device != device \
            or out.data.dtype != torch.float32:
        raise AssertionError(f"{name}: {tuple(out.shape)} {out.data.dtype} "
                             f"on {out.data.device}, expected {shape}")
    nan = torch.isnan(out.data).cpu()
    expect = _expected_nan(spec)
    if not torch.equal(nan, expect):
        raise AssertionError(f"{name}: NaN pattern differs from the holes "
                             f"({int((nan != expect).sum())} periods)")
    vals = out.data[~nan.to(out.data.device)]
    vmin, vmax = float(vals.min()), float(vals.max())
    mean = float(vals.double().mean())
    if not (lo <= vmin and vmax <= hi):
        raise AssertionError(f"{name}: values in [{vmin}, {vmax}], expected "
                             f"within [{lo}, {hi}]")
    return mean, int(nan.sum())


def phase_tg_mean(device, card, record):
    """The indicator slice at full size: atmos.tg_mean(tas, freq="MS")."""
    import torch

    from xclim_tpu_torch import indices
    from xclim_tpu_torch.indicators import atmos
    from xclim_tpu_torch.ops import segred

    tas = _tas(device)
    cells = TG_SIDE * TG_SIDE
    nbytes = tas.data.numel() * 4
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()

    # the main path's run: counts from zero, read right after
    _reset_counts()
    out = atmos.tg_mean(tas, freq="MS")
    torch.cuda.synchronize()
    counts = _counts()
    _log(f"[tg_mean] launch counts of one atmos.tg_mean(tas, freq='MS') at "
         f"{cells} cells: {json.dumps(counts)} (segred: the monthly mean and "
         f"the missing-value count)")
    if counts != dict({k: 0 for k in counts}, segred=2):
        raise AssertionError(f"tg_mean did not run on the kernel: {counts}")
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30

    # right answer by the repo's own means: shape, the NaN pattern of the
    # holes under missing_any, monthly means of N(285, 5) near 285 K
    # (sd 5/sqrt(28..31) < 1 K, so all within 285 +- 7 K), attributes
    spec = tas.resample("MS").spec
    mean, n_nan = _check_resampled("tg_mean", out, spec, device, 278.0,
                                   292.0)
    if abs(mean - 285.0) > 0.01:
        raise AssertionError(f"tg_mean mean {mean} K, expected 285 K")
    want = {"units": "K", "standard_name": "air_temperature",
            "long_name": "Mean daily mean temperature",
            "description": "Monthly mean of daily mean temperature.",
            "cell_methods": "time: mean over days"}
    got = {k: out.attrs.get(k) for k in want}
    if got != want or "tg_mean(tas=tas, freq='MS')" not in out.attrs.get(
            "history", ""):
        raise AssertionError(f"tg_mean attrs {out.attrs}")
    _log(f"[tg_mean] output {tuple(out.shape)} float32, mean {mean:.5f} K "
         f"(expect 285), {n_nan} NaN periods as the holes give, attrs ok")

    ind_s, ind_runs = _timed(lambda: atmos.tg_mean(tas, freq="MS"))
    del out
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    bare = indices.tg_mean(tas, freq="MS")
    torch.cuda.synchronize()
    bare_peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    if _counts()["segred"] != 1 or _counts()["segred_twin"] != 0:
        raise AssertionError(f"indices.tg_mean: {_counts()}")
    del bare
    idx_s, idx_runs = _timed(lambda: indices.tg_mean(tas, freq="MS"))
    for what, sec, runs, pk in (
            ("atmos.tg_mean (indicator: missing mask + attrs)", ind_s,
             ind_runs, peak),
            ("indices.tg_mean (bare index)", idx_s, idx_runs, bare_peak)):
        _log(f"[tg_mean] {what} ({TG_DAYS}, {TG_SIDE}, {TG_SIDE}) on {card}: "
             f"{sec:.5f} s (median of 3 after a warm-up; runs "
             f"{[round(v, 5) for v in runs]}), {TG_DAYS * cells / sec:.1f} "
             f"cell-days/s, peak device memory above the input "
             f"{pk:.3f} GiB (input {nbytes / 2**30:.3f} GiB)")

    # the minmax stat set through the public path
    tasmax = tas.copy()
    tasmax.name = "tasmax"
    tasmax.attrs = dict(tas.attrs, cell_methods="time: maximum")
    _reset_counts()
    tx = atmos.tx_max(tasmax, freq="YS")
    torch.cuda.synchronize()
    counts = _counts()
    if counts["segred"] != 2 or counts["segred_twin"] != 0:
        raise AssertionError(f"tx_max did not run on the kernel: {counts}")
    # the max of 365 N(285, 5) days lies above 291 K (z = 1.2) in all but
    # ~1e-20 of the lanes, and no day of 9.6e8 reaches 330 K (z = 9)
    txmean, _ = _check_resampled("tx_max", tx, tasmax.resample("YS").spec,
                                 device, 290.0, 330.0)
    _log(f"[tg_mean] atmos.tx_max(tasmax, freq='YS'): {tuple(tx.shape)}, "
         f"mean annual max {txmean:.4f} K (expect ~299.5 for 365 N(285, 5) "
         f"days), segred launches {counts['segred']}, units "
         f"{tx.attrs['units']}")
    del tx, tasmax

    # the kernel against its twin at the slice's own shape and input
    x2 = tas.data.reshape(TG_DAYS, -1)
    got = segred.segment_reduce_onepass(x2, spec.starts, spec.counts, "mean")
    ref = segred.segment_reduce_onepass_plain(x2, spec.starts, spec.counts,
                                              "mean")
    err = _compare(f"segred mean{tuple(x2.shape)}", got, ref, atol=0.0)
    del got, ref
    ms = _cuda_ms(lambda: segred.segment_reduce_onepass(
        x2, spec.starts, spec.counts, "mean"), 10)
    pms = _cuda_ms(lambda: segred.segment_reduce_onepass_plain(
        x2, spec.starts, spec.counts, "mean"), 2)
    record["segred"]["max_abs_err"] = max(record["segred"]["max_abs_err"],
                                          err)
    _log(f"[kernel vs twin] segred mean MS {tuple(x2.shape)} (slice shape) "
         f"on {card}: max_abs_err={err} kernel_ms={ms:.4f} twin_ms={pms:.4f}; "
         f"{nbytes / 1e9:.3f} GB read once: {nbytes / ms / 1e6:.1f} GB/s")
    return tas


def phase_tg_mean_cpu_vs_card(tas):
    """tg_mean on the first 1024 cells: CPU tensors (twins) vs the card."""
    import torch

    from xclim_tpu_torch.indicators import atmos

    sub = tas.isel(lat=slice(0, TG_CPU_CELLS // TG_SIDE))
    cpu = sub.to("cpu")
    before = _counts()
    out_c = atmos.tg_mean(cpu, freq="MS")
    out_g = atmos.tg_mean(sub, freq="MS")
    torch.cuda.synchronize()
    after = _counts()
    if (after["segred_twin"] - before["segred_twin"] != 2
            or after["segred"] - before["segred"] != 2):
        raise AssertionError(f"CPU run must use the twin, the card the "
                             f"kernel: {before} -> {after}")
    err = _compare("tg_mean cpu vs card", out_g.data, out_c.data, atol=0.0)
    ga = {k: v for k, v in out_g.attrs.items() if k != "history"}
    ca = {k: v for k, v in out_c.attrs.items() if k != "history"}
    if ga != ca or out_g.dims != out_c.dims:
        raise AssertionError(f"attrs differ: {ga} vs {ca}")
    _log(f"[cpu twins vs card kernels] tg_mean {TG_CPU_CELLS} cells: "
         f"max_abs_err={err}, NaN periods {int(torch.isnan(out_c.data).sum())}"
         f", attrs equal")


def _spell_lanes(gen, T, C, device):
    """(T, C) K-scale series for the spells comparison: lanes c % 4 == 0
    fully valid i.i.d. N(290, 5) days, 1 the same with 15 % missing, 2 all
    missing, 3 at 250 K with planted runs at 400 K: days 362-371 (across
    the first year boundary), 500-505 (exactly 6 days), 800-802 (exactly
    3) and 1000 (one day)."""
    import torch

    x = torch.randn((T, C), generator=gen, device=device) * 5.0 + 290.0
    lane = torch.arange(C, device=device) % 4
    holes = torch.rand((T, C), generator=gen, device=device) < 0.15
    x = torch.where(holes & (lane == 1), torch.nan, x)
    x = torch.where(lane == 2, torch.nan, x)
    planted = torch.full((T,), 250.0, device=device)
    for a, b in ((362, 372), (500, 506), (800, 803), (1000, 1001)):
        planted[a:b] = 400.0
    return torch.where(lane == 3, planted[:, None], x)


def _spell_cases(gen, device):
    """(label, input, (starts, counts), op, thresh) of spells at
    (SPELL_DAYS, C): YS and one segment over the whole series, 1024 and
    1000 cells, a float series and its condition."""
    from xclim_tpu_torch.core.calendar import date_range, resample_segments

    ys = resample_segments(date_range("1981-01-01", periods=SPELL_DAYS,
                                      calendar="noleap"), "YS")
    for cells in (SMALL_CELLS, 1000):
        x = _spell_lanes(gen, SPELL_DAYS, cells, device)
        for seg, segs in (("YS", (ys.starts, ys.counts)),
                          ("whole series", ([0], [SPELL_DAYS]))):
            yield f"{seg} {cells} float", x, segs, ">", 293.0
            yield f"{seg} {cells} bool", x > 293.0, segs, None, None


def kernel_times(device) -> dict:
    """Milliseconds of winquantile, spells, qdmadjust and axisquantile at
    the shapes this script times, through their public wrappers only
    (``doy_window_quantiles``, ``spell_stats``, ``qdm_adjust_doy``,
    ``axis_quantile_small``), on inputs made from SEED: the WQ_CASES, QDM's
    (365, 30, 16384) slices and the cells' (365, 30, 65536) at window 31,
    the _spell_cases, a
    bootstrap-shaped condition (29 replacement-major copies of (10950,
    4096), 10 % True, YS), the QDM_CASES and the AXQ_CASES, and QDM's adjust
    and the ensemble's quantile at their slices' shapes. Every version of
    the port has those wrappers, so this times an older checkout of the
    package too (``--kernel-times`` in main). Last, the ensemble t-test's
    p-values I_x(df / 2, 0.5) at (30, 192 x 448), df 181, 25 % of the cells
    missing: ``ops.betainc.betainc`` and its twin ``betainc_plain``, or,
    in a package without that op, the twin ``ensembles._robustness.
    _betainc``."""
    import torch

    from xclim_tpu_torch.core.calendar import date_range, resample_segments
    from xclim_tpu_torch.ops import axisquantile, qdmadjust, spells, winquantile
    from xclim_tpu_torch.sdba.utils import equally_spaced_nodes

    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    q = equally_spaced_nodes(NQ).astype("float32")
    out = {}
    for shape, window, kind in WQ_CASES:
        x = _wq_input(gen, shape, kind, device)
        out[f"winquantile {shape} w{window} {kind}"] = _cuda_ms(
            lambda: winquantile.doy_window_quantiles(x, q, window), 5)
    x = torch.randn((365, YEARS, SIDE * SIDE), generator=gen,
                    device=device) * 5.0 + 285.0
    out[f"winquantile {tuple(x.shape)} w{WINDOW} QDM"] = _cuda_ms(
        lambda: winquantile.doy_window_quantiles(x, q, WINDOW), 3)
    del x
    x = torch.randn((365, YEARS, WQ_CELLS), generator=gen,
                    device=device) * 5.0 + 285.0
    out[f"winquantile {tuple(x.shape)} w{WINDOW} cells"] = _cuda_ms(
        lambda: winquantile.doy_window_quantiles(x, q, WINDOW), 3)
    del x
    for label, arg, segs, op, thresh in _spell_cases(gen, device):
        out[f"spells {label}"] = _cuda_ms(
            lambda: spells.spell_stats(arg, *segs, 6, op, thresh), 20)
    ys = resample_segments(date_range("1981-01-01", periods=SPELL_DAYS,
                                      calendar="noleap"), "YS")
    cond = (torch.randint(0, 10, (29, SPELL_DAYS, PCT_SIDE * PCT_SIDE),
                          generator=gen, device=device, dtype=torch.uint8)
            == 0).permute(1, 2, 0)
    out[f"spells bootstrap {tuple(cond.shape)} YS bool"] = _cuda_ms(
        lambda: spells.spell_stats(cond, ys.starts, ys.counts, 6), 10)
    del cond
    for label, args in _qdm_cases(gen, device):
        out[f"qdmadjust {label}"] = _cuda_ms(
            lambda: qdmadjust.qdm_adjust_doy(*args), 10)
    x = torch.randn((365, YEARS, SIDE * SIDE), generator=gen,
                    device=device) * 6.0 + 289.0
    af = torch.sort(torch.randn((365, len(q), SIDE * SIDE), generator=gen,
                                device=device), dim=1).values
    out[f"qdmadjust {tuple(x.shape)} nq{len(q)} QDM"] = _cuda_ms(
        lambda: qdmadjust.qdm_adjust_doy(x, af, q, "+"), 10)
    del x, af
    for label, x, axis in _axq_cases(gen, device):
        out[f"axisquantile {label}"] = _cuda_ms(
            lambda: axisquantile.axis_quantile_small(x, AXQ_NODES, axis), 10)
    x = torch.randn((ENS_MEMBERS, ENS_DAYS, ENS_LAT, ENS_LON), generator=gen,
                    device=device) * 5.0 + 285.0
    ens_q = [v / 100.0 for v in ENS_VALUES]
    out[f"axisquantile {tuple(x.shape)} ensembles"] = _cuda_ms(
        lambda: axisquantile.axis_quantile_small(x, ens_q, 0), 10)
    del x
    cells = ENS_LAT * ENS_LON
    df = torch.full((ENS_MEMBERS, cells), 181.0, device=device)
    warm = torch.rand((ENS_MEMBERS, 1), generator=gen, device=device) * 2.0
    t = torch.randn(df.shape, generator=gen, device=device) + 1.35 * warm
    missing = torch.rand((cells,), generator=gen, device=device) < 0.25
    df[:, missing] = 1.0
    x = df / (df + t * t)
    x[:, missing] = torch.nan
    a = df / 2.0
    try:
        from xclim_tpu_torch.ops import betainc
    except ImportError:
        from xclim_tpu_torch.ensembles._robustness import _betainc as twin
    else:
        twin = betainc.betainc_plain
        out[f"betainc {tuple(x.shape)} ttest"] = _cuda_ms(
            lambda: betainc.betainc(a, 0.5, x), 20)
    out[f"betainc twin {tuple(x.shape)} ttest"] = _cuda_ms(
        lambda: twin(a, 0.5, x), 3)
    return out


def _tasmax(device, side, years=PCT_YEARS):
    """tasmax (years * 365, side, side) float32 K from 1981-01-01, noleap:
    295 K + a 10 K seasonal cycle (peak in mid-July) + 5 K x an AR(1)
    anomaly with phi = 0.8 and unit variance, from a seeded generator.
    Without the autocorrelation, warm spells of 6 days above the 90th
    percentile would almost never occur."""
    import math

    import numpy as np
    import torch

    from xclim_tpu_torch.core.calendar import date_range
    from xclim_tpu_torch.core.dataarray import ClimArray

    t = date_range("1981-01-01", periods=years * 365, freq="D",
                   calendar="noleap")
    T = len(t)
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    ar = torch.randn((T, side, side), generator=gen, device=device)
    ar[1:] *= math.sqrt(1.0 - PHI ** 2)
    for i in range(1, T):   # ar[i] = phi * ar[i-1] + e[i], in place
        ar[i].add_(ar[i - 1], alpha=PHI)
    season = torch.as_tensor(10.0 * np.sin(2 * np.pi * (t.doy - 105) / 365),
                             dtype=torch.float32, device=device)
    data = ar.mul_(5.0).add_(season[:, None, None]).add_(295.0)
    coords = {"time": t, "lat": np.arange(side), "lon": np.arange(side)}
    return ClimArray(data, ("time", "lat", "lon"), coords,
                     {"units": "K", "standard_name": "air_temperature",
                      "cell_methods": "time: maximum"}, "tasmax")


def _pct_calls(tasmax):
    """The slice's three public calls."""
    from xclim_tpu_torch.core.percentiles import percentile_doy
    from xclim_tpu_torch.indicators import atmos

    per = percentile_doy(tasmax, window=5, per=90)
    tx = atmos.tx90p(tasmax, tasmax_per=per, freq="YS", bootstrap=True)
    wsdi = atmos.warm_spell_duration_index(tasmax, tasmax_per=per, window=6,
                                           freq="YS", bootstrap=True)
    return per, tx, wsdi


def _check_pct(per, tx, wsdi, side, device):
    """Values by the repo's own means; returns a summary dict."""
    import torch

    nper = (365, side, side, 1)
    if tuple(per.shape) != nper or not bool(torch.isfinite(per.data).all()):
        raise AssertionError(f"percentile_doy: {tuple(per.shape)}, finite "
                             f"{bool(torch.isfinite(per.data).all())}")
    # the outputs keep per's "percentiles" dim (size 1), as the reference's
    for name, out in (("tx90p", tx), ("wsdi", wsdi)):
        if tuple(out.shape) != (PCT_YEARS, side, side, 1) \
                or out.data.device != device:
            raise AssertionError(f"{name}: {tuple(out.shape)} on "
                                 f"{out.data.device}")
        if bool(torch.isnan(out.data).any()):
            raise AssertionError(f"{name}: NaN in a complete series")
        if out.attrs.get("units") != "days":
            raise AssertionError(f"{name} units {out.attrs.get('units')}")
    # every year is in base, so each is a mean over 29 replacements of the
    # days above a 90th percentile taken from the other years: 10 % of 365
    # days, plus the out-of-sample excess of a quantile estimated from 29
    # autocorrelated years (39.05 days, 10.7 %, on 16 and on 64 cells of
    # this series). The mean over the cell-years has a standard error well
    # below a day.
    txm = float(tx.data.double().mean())
    if not 35.0 <= txm <= 42.0:
        raise AssertionError(f"mean tx90p {txm} days, expected 35-42")
    # days in warm spells are a subset of the days above the threshold, for
    # each replacement and so for their mean
    if bool((wsdi.data > tx.data).any()):
        raise AssertionError("WSDI exceeds tx90p somewhere")
    frac = float((wsdi.data.sum(dim=0) > 0).double().mean())
    if frac < 0.9:
        raise AssertionError(f"WSDI > 0 in only {frac:.3f} of the cells")
    return {"tx90p_mean_days": txm,
            "wsdi_mean_days": float(wsdi.data.double().mean()),
            "cells_with_wsdi": frac,
            "cell_years_with_wsdi": float((wsdi.data > 0).double().mean())}


def _capture(module, name, n, run):
    """The (args, kwargs) of the first n calls of module.name made by
    run(); the calls themselves go through."""
    seen = []
    kernel = getattr(module, name)

    def capture(*args, **kwargs):
        if len(seen) < n:
            seen.append((args, kwargs))
        return kernel(*args, **kwargs)

    setattr(module, name, capture)
    try:
        run()
    finally:
        setattr(module, name, kernel)
    return seen


def phase_percentiles(device, card, record):
    """The percentile slice at full size: percentile_doy, tx90p and WSDI
    with the bootstrap at 64 x 64 cells x 30 years."""
    import numpy as np
    import torch

    from perfbench import roofline
    from xclim_tpu_torch.core.percentiles import percentile_doy
    from xclim_tpu_torch.indicators import atmos
    from xclim_tpu_torch.ops import segred, spells

    tasmax = _tasmax(device, PCT_SIDE)
    T, cells = tasmax.shape[0], PCT_SIDE * PCT_SIDE
    torch.cuda.synchronize()

    # the main path's runs: counts from zero before each call, read right
    # after. tx90p: one segred sum of the exceedance mask for the plain
    # result and one per in-base year (all 30: the 29 replacements ride on
    # the batch), plus the missing-value count; WSDI: one spells launch for
    # the plain result and one per in-base year, plus the same segred count.
    # Both: one bootstrap launch per in-base year at q 0.9 (its 29
    # replacements in one launch, the table in shared memory: K 23, w 5).
    _reset_counts()
    per = percentile_doy(tasmax, window=5, per=90)
    torch.cuda.synchronize()
    c_per = _counts()
    _reset_counts()
    tx = atmos.tx90p(tasmax, tasmax_per=per, freq="YS", bootstrap=True)
    torch.cuda.synchronize()
    c_tx = _counts()
    _reset_counts()
    wsdi = atmos.warm_spell_duration_index(tasmax, tasmax_per=per, window=6,
                                           freq="YS", bootstrap=True)
    torch.cuda.synchronize()
    c_ws = _counts()
    zero = {k: 0 for k in c_per}
    boot = dict(bootstrap=PCT_YEARS, bootstrap_shared=PCT_YEARS)
    want_per = dict(zero, doyquantile=1)
    want_tx = dict(zero, segred=PCT_YEARS + 2, **boot)
    want_ws = dict(zero, segred=1, spells=PCT_YEARS + 1, **boot)
    _log(f"[percentiles] launch counts at {cells} cells x {PCT_YEARS} y: "
         f"percentile_doy {json.dumps(c_per)}; tx90p+bootstrap "
         f"{json.dumps(c_tx)}; WSDI+bootstrap {json.dumps(c_ws)}")
    if c_per != want_per or c_tx != want_tx or c_ws != want_ws:
        raise AssertionError(f"the percentile slice missed its kernels: "
                             f"expected {want_per}, {want_tx} and {want_ws}")
    record["doyquantile"]["launches"] = c_per["doyquantile"]
    record["spells"]["launches"] = c_ws["spells"]
    record["segred"]["launches"] = c_tx["segred"]
    record["bootstrap"]["launches"] = c_tx["bootstrap"]
    record["bootstrap"]["paths"].update(
        {"tx90p shared": c_tx["bootstrap_shared"],
         "wsdi shared": c_ws["bootstrap_shared"]})
    summary = _check_pct(per, tx, wsdi, PCT_SIDE, device)
    _log(f"[percentiles] values: {json.dumps(summary)}")
    del tx, wsdi

    rate = T * cells
    for name, fn in (
            ("percentile_doy(tasmax, 5, 90)",
             lambda: percentile_doy(tasmax, window=5, per=90)),
            ("atmos.tx90p(bootstrap=True)",
             lambda: atmos.tx90p(tasmax, tasmax_per=per, freq="YS",
                                 bootstrap=True)),
            ("atmos.warm_spell_duration_index(bootstrap=True)",
             lambda: atmos.warm_spell_duration_index(
                 tasmax, tasmax_per=per, window=6, freq="YS",
                 bootstrap=True))):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        sec, runs = _timed(fn)
        peak = (torch.cuda.max_memory_allocated() - base) / 2**30
        _log(f"[percentiles] {name} ({T}, {PCT_SIDE}, {PCT_SIDE}) on {card}: "
             f"{sec:.4f} s (median of 3 after a warm-up; runs "
             f"{[round(v, 4) for v in runs]}), {rate / sec:.1f} cell-days/s, "
             f"peak device memory above the input {peak:.3f} GiB")

    # segred against its twin at the bootstrap's own inputs: the exceedance
    # sums of the plain result, (T, 4096), and of the first in-base year's
    # 29 replacements after segment_reduce's replacement-major copy, (T,
    # 29 * 4096), from the first two segred calls of one tx90p run. Sums
    # of a 0/1 mask: bit-equal.
    # The second call, the larger, gives the segred record its times, its
    # bound and the library call: torch.segment_reduce computes the same
    # NaN-free sums. The port never calls it.
    calls = _capture(segred, "segment_reduce_onepass", 2, lambda: atmos.tx90p(
        tasmax, tasmax_per=per, freq="YS", bootstrap=True))
    for args, kwargs in calls:
        x2, starts, counts, op = args
        got = segred.segment_reduce_onepass(*args, **kwargs)
        ref = segred.segment_reduce_onepass_plain(*args, **kwargs)
        err = _compare(f"segred {op}{tuple(x2.shape)} at tx90p's mask", got,
                       ref, rtol=0.0, atol=0.0)
        lengths = torch.as_tensor(np.asarray(counts), device=x2.device)
        lib = torch.segment_reduce(x2, "sum", lengths=lengths, axis=0)
        lib_err = float((lib - got).abs().max())
        del got, ref, lib
        ms = _cuda_ms(lambda: segred.segment_reduce_onepass(*args, **kwargs),
                      10)
        pms = _cuda_ms(lambda: segred.segment_reduce_onepass_plain(
            *args, **kwargs), 2)
        lms = _cuda_ms(lambda: torch.segment_reduce(x2, "sum",
                                                    lengths=lengths, axis=0),
                       10)
        record["segred"]["max_abs_err"] = max(record["segred"]["max_abs_err"],
                                              err)
        bound = roofline.bound((x2.numel() + len(counts) * x2.shape[1]) * 4,
                       x2.numel())
        record["segred"].update(ms=ms, plain_ms=pms, library_ms=lms, **bound)
        _log(f"[kernel vs twin] segred {op} {tuple(x2.shape)} (tx90p's "
             f"exceedance mask) on {card}: max_abs_err={err} "
             f"kernel_ms={ms:.4f} twin_ms={pms:.4f} torch.segment_reduce_ms="
             f"{lms:.4f} (max diff {lib_err}) bound_ms="
             f"{bound['bound_ms']:.4f} ({bound['bound_by']})")
    del calls, x2, args, kwargs

    # spells against its twin at the bootstrap's own input: the WSDI
    # condition of the first in-base year's 29 replacements, taken from
    # the second spells call of one WSDI run
    (cond, *args), kwargs = _capture(
        spells, "spell_stats", 2, lambda: atmos.warm_spell_duration_index(
            tasmax, tasmax_per=per, window=6, freq="YS", bootstrap=True))[1]
    got = spells.spell_stats(cond, *args, **kwargs)
    ref = spells.spell_stats_plain(cond, *args, **kwargs)
    err = max(_compare(f"spells {n} at the bootstrap's condition", g, r,
                       rtol=0.0, atol=0.0)
              for g, r, n in zip(got, ref, ("cnt", "wrc", "wre", "lng")))
    del ref
    ms = _cuda_ms(lambda: spells.spell_stats(cond, *args, **kwargs), 10)
    pms = _cuda_ms(lambda: spells.spell_stats_plain(cond, *args, **kwargs), 2)
    # bound: the 1-byte condition read once, four (B, nseg, C) float32
    # results written once; operations: ~4 a day and column
    nbytes = cond.numel() * cond.element_size()
    outs = 4 * len(args[0]) * cond.numel() // cond.shape[0] * 4
    record["spells"].update(
        max_abs_err=max(record["spells"]["max_abs_err"], err), ms=ms,
        plain_ms=pms, **roofline.bound(nbytes + outs, 4 * cond.numel()))
    _log(f"[kernel vs twin] spells bool {tuple(cond.shape)} (the bootstrap's "
         f"condition, {nbytes / 1e9:.3f} GB) on {card}: max_abs_err={err} "
         f"kernel_ms={ms:.4f} twin_ms={pms:.4f}; {nbytes / ms / 1e6:.1f} GB/s; "
         f"bound_ms={record['spells']['bound_ms']:.4f}")
    del got, cond, args, kwargs
    _bootstrap_at_the_cell(tasmax, per, card, record)
    _doyquantile_at_the_cell(tasmax, card, record)
    return tasmax


def _doyquantile_at_the_cell(tasmax, card, record):
    """The doyquantile kernel against its twin at percentile_doy's own
    call (the (T, 4096) series, its (365, 150) table, q 0.9, type 8), value
    for value; the twin (the gather and the sort) on the same card. Times:
    the kernel and the twin by CUDA events."""
    import torch

    from perfbench import roofline
    from xclim_tpu_torch.core.percentiles import percentile_doy
    from xclim_tpu_torch.ops import doyquantile

    (args, kwargs), = _capture(
        doyquantile, "doy_quantile", 1,
        lambda: percentile_doy(tasmax, window=5, per=90))
    series, table = args[:2]

    def kernel():
        return doyquantile.doy_quantile(*args, **kwargs)

    def twin():
        return doyquantile.doy_quantile_plain(*args[:5])

    before = doyquantile.launches
    got = kernel()
    torch.cuda.synchronize()
    if doyquantile.launches != before + 1:
        raise AssertionError("percentile_doy's quantile missed its kernel")
    ref = twin()
    err = _compare(f"doyquantile {tuple(got.shape)} at percentile_doy's "
                   f"series", got, ref, rtol=0.0, atol=0.0)
    del ref
    ms = _cuda_ms(kernel, 20)
    pms = _cuda_ms(twin, 2)
    # bytes: the series and the table read once, the thresholds written
    # once; operations: the interpolation's few a threshold
    bound = roofline.bound(roofline.tensor_bytes(series, table, got),
                           4 * got.numel())
    record["doyquantile"].update(
        max_abs_err=max(record["doyquantile"]["max_abs_err"], err), ms=ms,
        plain_ms=pms, **bound)
    _log(f"[kernel vs twin] doyquantile {tuple(series.shape)} through the "
         f"{tuple(table.shape)} table (percentile_doy's call) on {card}: "
         f"max_abs_err={err} kernel_ms={ms:.4f} twin_ms={pms:.4f} "
         f"bound_ms={bound['bound_ms']:.4f} ({bound['bound_by']})")


def _bootstrap_at_the_cell(tasmax, per, card, record):
    """The bootstrap kernel against its twin at tx90p's own inputs: the
    first in-base year's call (365 doys, 30 years, w 5, 4096 cells, q the
    float32 0.9 of the thresholds' attributes, so K 23), bit for bit. The twin runs on the same card on the other years'
    copy, as the bootstrap called it before the kernel. Times: the kernel
    back to back, after a write of 256 MB that leaves nothing of its
    inputs in L2, and the twin."""
    import torch

    from perfbench import roofline
    from xclim_tpu_torch.core import bootstrapping
    from xclim_tpu_torch.indicators import atmos
    from xclim_tpu_torch.ops import bootstrap

    (args, kwargs), = _capture(
        bootstrapping, "merge_rank_replaced_year_quantile", 1,
        lambda: atmos.tx90p(tasmax, tasmax_per=per, freq="YS",
                            bootstrap=True))
    topv, topyear, botv, botyear, nvalid, _, _, b, q = args
    D = kwargs["samples"]
    n_doy, ny, w, C = D.shape
    others = torch.as_tensor([o for o in range(ny) if o != b],
                             device=D.device)
    A_b = D[:, b].movedim(-1, -2)
    A_o = D.index_select(1, others).permute(1, 0, 3, 2)

    def kernel():
        return bootstrap.merge_rank_replaced_year_quantile(*args, **kwargs)

    def twin():
        return bootstrap.merge_rank_replaced_year_quantile_plain(
            topv, topyear, botv, botyear, nvalid, A_b, A_o, b, q,
            alpha=kwargs["alpha"], beta=kwargs["beta"])

    before = _counts()
    got = kernel()
    torch.cuda.synchronize()
    moved = {k: v - before[k] for k, v in _counts().items()
             if k.startswith("bootstrap") and v != before[k]}
    if moved != {"bootstrap": 1, "bootstrap_shared": 1}:
        raise AssertionError(f"the bootstrap call missed its kernel: {moved}")
    ref = twin()
    err = _compare(f"bootstrap {tuple(got.shape)} at tx90p's samples", got,
                   ref, rtol=0.0, atol=0.0)
    if not torch.equal(torch.nan_to_num(got), torch.nan_to_num(ref)):
        raise AssertionError("bootstrap: the kernel's bits differ from the "
                             "twin's")
    del got, ref
    ms = _cuda_ms(kernel, 20)
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device=D.device)
    flush_ms = _cuda_ms(flush.zero_, 20)
    cold_ms = _cuda_ms(lambda: (flush.zero_(), kernel()), 20) - flush_ms
    del flush
    pms = _cuda_ms(twin, 2)
    # bytes: the samples, one table with its year tags, the valid counts
    # read once, the (29, n_doy, C) result written once; operations: the
    # sorting network (w rounds of w/2 compare-exchanges, 2 each) and the
    # two merge-path reads (w + 1 splits, 2 each) per lane and replacement
    tab = topv if q >= 0.5 else botv
    nbytes = (D.numel() + 2 * tab.numel() + nvalid.numel()
              + (ny - 1) * n_doy * C) * 4
    bound = roofline.bound(nbytes,
                           (ny - 1) * n_doy * C * (w * w + 4 * (w + 1)))
    record["bootstrap"].update(
        max_abs_err=max(record["bootstrap"]["max_abs_err"], err), ms=ms,
        ms_after_l2_flush=cold_ms, plain_ms=pms, **bound)
    _log(f"[kernel vs twin] bootstrap {tuple(D.shape)} K {tab.shape[-1]} q "
         f"{q!r} year {b} (tx90p's samples, {nbytes / 1e9:.3f} GB) on {card}: "
         f"bit-equal, kernel_ms={ms:.4f} (after an L2 flush {cold_ms:.4f}) "
         f"twin_ms={pms:.4f} bound_ms={bound['bound_ms']:.4f} "
         f"({bound['bound_by']})")


def phase_percentiles_cpu_vs_card(tasmax):
    """The slice's calls on the first PCT_CPU_CELLS cells: CPU tensors (the
    twins) against the card (the kernels)."""
    import torch

    rows = PCT_CPU_CELLS // PCT_SIDE
    sub = tasmax.isel(lat=slice(0, rows))
    before = _counts()
    t0 = time.perf_counter()
    outs_c = _pct_calls(sub.to("cpu"))
    cpu_s = time.perf_counter() - t0
    outs_g = _pct_calls(sub)
    torch.cuda.synchronize()
    after = _counts()
    d = {k: after[k] - before[k] for k in after}
    if (d["spells_twin"] != PCT_YEARS + 1 or d["spells"] != PCT_YEARS + 1
            or d["segred_twin"] != PCT_YEARS + 3
            or d["segred"] != PCT_YEARS + 3
            or d["bootstrap_twin"] != 2 * PCT_YEARS
            or d["bootstrap"] != 2 * PCT_YEARS
            or d["doyquantile_twin"] != 1 or d["doyquantile"] != 1):
        raise AssertionError(f"CPU run must use the twins, the card the "
                             f"kernels: {d}")
    errs = [_compare(f"{name} cpu vs card", g.data, c.data, atol=0.0)
            for name, g, c in zip(("percentile_doy", "tx90p", "wsdi"),
                                  outs_g, outs_c)]
    _log(f"[cpu twins vs card kernels] percentile_doy, tx90p and WSDI with "
         f"the bootstrap on {PCT_CPU_CELLS} cells x {PCT_YEARS} y: max_abs_err "
         f"{errs} (CPU side {cpu_s:.1f} s)")


#: axisquantile's route cases: samples on axis 1 of (pre, M, post) with
#: ~64 K columns, the ensemble's nodes
AXQ_MS = (13, 30, 64)
AXQ_NODES = [0.1, 0.5, 0.9]


def _axq_cases(gen, device):
    """(label, x, axis) of axisquantile at M in AXQ_MS samples: post 1, 3,
    5, 4099 and 4 (direct loads), post 256 and 4100 (the shared-memory
    ring; 4100 ends each p with a partial tile), and a contiguous view
    whose start is not 16-byte aligned (direct), 20 % missing, an
    all-missing column."""
    import torch

    for M in AXQ_MS:
        for post in (1, 3, 5, 4099, 4, 256, 4100, "unaligned"):
            n = 4100 if post == "unaligned" else post
            shape = (max(1, 65536 // n), M, n)
            size = shape[0] * M * n
            buf = torch.randn(size + 1, generator=gen, device=device)
            x = (buf[1:] if post == "unaligned" else buf[:size]).view(shape)
            x.mul_(5.0).add_(285.0)
            holes = torch.rand(shape, generator=gen, device=device) < 0.2
            x.masked_fill_(holes, torch.nan)
            x[0, :, 0] = torch.nan
            yield f"M{M} post{post}", x, 1


def _profile(name, fn, card, top=10):
    """torch.profiler over one fn() after a warm-up: wall time, summed
    device time of its kernels, the device's idle share of the wall, and
    the kernels with the most device time. Returns (kernel launches,
    kernel ms)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    # kernels only: an aten op's entry repeats the device time of the
    # kernels it launched
    rows = sorted((e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and dev_us(e) > 0),
                  key=dev_us, reverse=True)
    busy_ms = sum(dev_us(e) for e in rows) / 1e3
    launches = sum(e.count for e in rows)
    if not rows:
        _log(f"[profile] {name}: no device time in the trace; wall "
             f"{wall_ms:.3f} ms")
        return 0, 0.0
    _log(f"[profile] {name} on {card}: wall {wall_ms:.3f} ms (profiled), "
         f"kernel time {busy_ms:.3f} ms in {launches} "
         f"launches, idle {max(0.0, 1.0 - busy_ms / wall_ms) * 100:.1f} %")
    for e in rows[:top]:
        _log(f"[profile]   {dev_us(e) / 1e3:9.3f} ms  {e.count:5d}x  "
             f"{e.key[:90]}")
    return launches, busy_ms


def _ensemble(device):
    """30 members of tas (365 noleap days from 2000-01-01, 192 x 448 cells)
    from a seeded generator: 285 K + 5 K of daily noise + a member-specific
    warming over the year (0-2 K, so fut and hist differ for some members
    and not others). Planted NaN: cell (0, 0) misses every member, cell
    (0, 1) all but member 0, cell (1, j) members 0..j (j < 10)."""
    import numpy as np
    import torch

    from xclim_tpu_torch.core.calendar import date_range
    from xclim_tpu_torch.core.dataarray import ClimArray
    from xclim_tpu_torch.ensembles import create_ensemble

    t = date_range("2000-01-01", periods=ENS_DAYS, freq="D", calendar="noleap")
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    ramp = torch.linspace(0.0, 1.0, ENS_DAYS, device=device)[:, None, None]
    warm = torch.rand((ENS_MEMBERS,), generator=gen, device=device) * 2.0
    coords = {"time": t, "lat": np.arange(ENS_LAT), "lon": np.arange(ENS_LON)}
    members = []
    for m in range(ENS_MEMBERS):
        d = torch.randn((ENS_DAYS, ENS_LAT, ENS_LON), generator=gen,
                        device=device)
        d.mul_(5.0).add_(285.0).add_(ramp * warm[m])
        d[:, 0, 0] = torch.nan
        if m >= 1:
            d[:, 0, 1] = torch.nan
        d[:, 1, m:10] = torch.nan
        members.append(ClimArray(d, ("time", "lat", "lon"), coords,
                                 {"units": "K",
                                  "standard_name": "air_temperature"}, "tas"))
    return create_ensemble(members)


def _ens_calls(ens):
    """The slice's two public calls, as bench.py:773-778 composes them."""
    from xclim_tpu_torch.ensembles import (
        ensemble_percentiles,
        robustness_fractions,
    )

    per = ensemble_percentiles(ens, values=ENS_VALUES)
    fut = ens.isel(time=slice(183, 365))
    hist = ens.isel(time=slice(0, 182))
    return per, robustness_fractions(fut, hist, test="ttest")


def _check_ens(ens, per, rf):
    """Values by the repo's own means; returns a summary dict."""
    import torch

    p10, p50, p90 = (per[float(v)].data for v in ENS_VALUES)
    shape = (ENS_DAYS, ENS_LAT, ENS_LON)
    if any(tuple(p.shape) != shape for p in (p10, p50, p90)):
        raise AssertionError(f"percentiles {tuple(p10.shape)}, expected {shape}")
    nan = torch.isnan(p50)
    expect = torch.zeros(shape, dtype=torch.bool, device=nan.device)
    expect[:, 0, 0] = True
    if not all(torch.equal(torch.isnan(p), expect) for p in (p10, p50, p90)):
        raise AssertionError("percentiles: NaN away from the all-NaN cell")
    if bool((p10[~nan] > p50[~nan]).any() or (p50[~nan] > p90[~nan]).any()):
        raise AssertionError("p10 <= p50 <= p90 fails")
    single = ens.data[0, :, 0, 1]
    if not all(torch.equal(p[:, 0, 1], single) for p in (p10, p50, p90)):
        raise AssertionError("the single valid member's value is not every "
                             "percentile of its cell")
    fr = {k: rf[k].data for k in rf.keys() if k != "pvals"}
    for k, v in fr.items():
        if tuple(v.shape) != (ENS_LAT, ENS_LON) or bool(
                ((v < 0) | (v > 1) | torch.isnan(v)).any()):
            raise AssertionError(f"fraction {k}: outside [0, 1]")
    # changed counts the valid members that changed significantly; the
    # significant positive and negative ones are disjoint parts of it
    if bool((fr["changed_positive"] + fr["changed_negative"]
             > fr["changed"] + 1e-6).any()):
        raise AssertionError("changed_positive + changed_negative > changed")
    valid = fr["valid"]
    want = [(0, 0, 0.0), (0, 1, 1 / ENS_MEMBERS)] + [
        (1, j, (ENS_MEMBERS - j - 1) / ENS_MEMBERS) for j in range(10)]
    for i, j, v in want:
        if abs(float(valid[i, j]) - v) > 1e-6:
            raise AssertionError(f"valid[{i}, {j}] = {float(valid[i, j])}, "
                                 f"expected {v}")
    changed = float(fr["changed"].double().mean())
    if not 0.05 < changed < 0.95:
        raise AssertionError(f"mean changed fraction {changed}: the members' "
                             f"warming should split them")
    pv = rf["pvals"].data
    if tuple(pv.shape) != (ENS_MEMBERS, ENS_LAT, ENS_LON):
        raise AssertionError(f"pvals {tuple(pv.shape)}")
    return {"p50_mean_K": float(p50[~nan].double().mean()),
            "p90_minus_p10_mean_K": float((p90 - p10)[~nan].double().mean()),
            "changed_mean": changed,
            "positive_mean": float(fr["positive"].double().mean()),
            "valid_mean": float(valid.double().mean())}


def phase_ensembles(device, card, record):
    """The ensembles slice at full size: ensemble_percentiles + ttest
    robustness_fractions over 30 members x 365 days x 192 x 448 cells."""
    import torch

    from perfbench import roofline
    from xclim_tpu_torch.ensembles import (
        ensemble_percentiles,
        robustness_fractions,
    )
    from xclim_tpu_torch.ops import axisquantile, betainc

    ens = _ensemble(device)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    nbytes = ens.data.numel() * 4
    cells = ENS_LAT * ENS_LON

    # the main path's runs: counts from zero before each call, read right
    # after. ensemble_percentiles: one axisquantile launch (all three nodes
    # in one pass); robustness_fractions(ttest): one betainc launch (the
    # time moments are plain torch).
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    per = ensemble_percentiles(ens, values=ENS_VALUES)
    torch.cuda.synchronize()
    c_per = _counts()
    _reset_counts()
    rf = robustness_fractions(ens.isel(time=slice(183, 365)),
                              ens.isel(time=slice(0, 182)), test="ttest")
    torch.cuda.synchronize()
    c_rf = _counts()
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    zero = {k: 0 for k in c_per}
    _log(f"[ensembles] launch counts at {ENS_MEMBERS} members x {ENS_DAYS} "
         f"days x {cells} cells: ensemble_percentiles {json.dumps(c_per)}; "
         f"robustness_fractions(ttest) {json.dumps(c_rf)}")
    if c_per != dict(zero, axisquantile=1, axisquantile_staged=1) \
            or c_rf != dict(zero, betainc=1):
        raise AssertionError("the ensembles slice missed its kernels")
    record["axisquantile"]["launches"] = c_per["axisquantile"]
    record["betainc"]["launches"] = c_rf["betainc"]
    summary = _check_ens(ens, per, rf)
    _log(f"[ensembles] values: {json.dumps(summary)}; peak device memory of "
         f"the pair above the input {peak:.3f} GiB (input "
         f"{nbytes / 2**30:.3f} GiB)")
    del per, rf

    # the kernel against its twin, and torch.nanquantile (alpha = beta = 1:
    # the same function; the port never calls it), at the call's own input
    (args, kwargs), = _capture(axisquantile, "axis_quantile_small", 1,
                               lambda: ensemble_percentiles(
                                   ens, values=ENS_VALUES))
    x, q = args[0], args[1]
    got = axisquantile.axis_quantile_small(*args, **kwargs)
    torch.cuda.synchronize()
    ref = axisquantile.axis_quantile_small_plain(*args, **kwargs)
    err = _compare(f"axisquantile{tuple(x.shape)} at the ensemble's input",
                   got, ref, rtol=0.0, atol=0.0)
    del ref
    qt = torch.as_tensor(q, dtype=torch.float32, device=x.device)

    def library():
        return torch.nanquantile(x, qt, dim=0)
    lib = library()
    lib_err = float(torch.nan_to_num((lib - got).abs()).max())
    del lib
    ms = _cuda_ms(lambda: axisquantile.axis_quantile_small(*args, **kwargs),
                  10)
    pms = _cuda_ms(lambda: axisquantile.axis_quantile_small_plain(
        *args, **kwargs), 2)
    lms = _cuda_ms(library, 2)
    cols = x.numel() // x.shape[0]
    # bound: x read once, the nodes written once; operations: a comparison
    # sort of each column's valid members, ~8 per node for the selection
    bound = roofline.bound((x.numel() + len(q) * cols) * 4,
                   _sort_compares((~torch.isnan(x)).sum(dim=0))
                   + 8 * len(q) * cols)
    record["axisquantile"].update(
        max_abs_err=max(record["axisquantile"]["max_abs_err"], err), ms=ms,
        plain_ms=pms, library_ms=lms, **bound)
    _log(f"[kernel vs twin] axisquantile {tuple(x.shape)} (the ensemble's "
         f"input, {nbytes / 1e9:.3f} GB) on {card}: max_abs_err={err} "
         f"kernel_ms={ms:.4f} twin_ms={pms:.4f} torch.nanquantile_ms="
         f"{lms:.4f} (max diff to the kernel {lib_err}) "
         f"bound_ms={bound['bound_ms']:.4f} ({bound['bound_by']}); "
         f"{(x.numel() + len(q) * cols) * 4 / ms / 1e6:.1f} GB/s")
    del x

    # the betainc kernel against its twin at the t-test's own arguments
    (args, kwargs), = _capture(betainc, "betainc", 1,
                               lambda: robustness_fractions(
                                   ens.isel(time=slice(183, 365)),
                                   ens.isel(time=slice(0, 182)),
                                   test="ttest"))
    a, b, x = args[:3]
    got = betainc.betainc(*args, **kwargs)
    torch.cuda.synchronize()
    ref = betainc.betainc_plain(*args, **kwargs)
    err = _betainc_compare(f"betainc{tuple(got.shape)} at the t-test's "
                           f"arguments", got, ref, a, b, x)
    del ref
    ms = _cuda_ms(lambda: betainc.betainc(*args, **kwargs), 20)
    pms = _cuda_ms(lambda: betainc.betainc_plain(*args, **kwargs), 2)
    # bound: the full-size operands read once, the result written once;
    # the terms each element takes are not counted, so no operations
    nbytes = sum(v.numel() * 4 for v in (a, b, x)
                 if isinstance(v, torch.Tensor) and v.numel() > 1)
    bound = roofline.bound(nbytes + got.numel() * 4, 0)
    record["betainc"].update(
        max_abs_err=max(record["betainc"]["max_abs_err"], err), ms=ms,
        plain_ms=pms, **bound)
    _log(f"[kernel vs twin] betainc {tuple(got.shape)} (the t-test's "
         f"p-values, b {b if not isinstance(b, torch.Tensor) else 'tensor'})"
         f" on {card}: max_abs_err={err} kernel_ms={ms:.4f} "
         f"twin_ms={pms:.4f} bound_ms={bound['bound_ms']:.4f} "
         f"({bound['bound_by']}, operations not counted)")
    return ens


def _betainc_compare(name, got, ref, a, b, x) -> float:
    """Max abs error of the betainc kernel against its twin; raises on a
    NaN-pattern mismatch or an element beyond atol 1e-6 and rtol 1e-5 plus
    BETAINC_DRIFT of h * factor (the result, or 1 minus it where the
    arguments were swapped)."""
    import torch

    a, b, x = torch.broadcast_tensors(*(
        torch.as_tensor(v, dtype=torch.float32, device=got.device)
        for v in (a, b, x)))
    swapped = ~(x < (a + 1.0) / (a + b + 2.0))
    hf = torch.where(swapped, 1.0 - ref, ref)
    got, ref, hf = (v.double().cpu() for v in (got, ref, hf))
    gn, rn = torch.isnan(got), torch.isnan(ref)
    if not torch.equal(gn, rn):
        raise AssertionError(f"{name}: NaN patterns differ "
                             f"({int((gn != rn).sum())} elements)")
    ok = ~rn
    err = (got - ref).abs()[ok]
    bound = 1e-6 + 1e-5 * ref.abs()[ok] + BETAINC_DRIFT * hf.abs()[ok]
    if err.numel() and bool((err > bound).any()):
        raise AssertionError(f"{name}: {int((err > bound).sum())} elements "
                             f"beyond the bound, max abs err "
                             f"{float(err.max())}")
    return float(err.max()) if err.numel() else 0.0


def phase_ensembles_cpu_vs_card(ens):
    """The slice's calls on the first 1024 cells: CPU tensors (the twin)
    against the card (the kernel). Percentiles value-equal; p-values within
    P_RTOL (P_NEAR_ONE absolute from 0.5 up); fractions equal, except
    changed* in cells where a member's p-value lies within P_RTOL of
    p_change = 0.05, and positive, negative and agree where one lies within
    P_NEAR_ONE of 1."""
    import torch

    sub = ens.isel(lat=slice(0, ENS_CPU[0]), lon=slice(0, ENS_CPU[1]))
    before = _counts()
    per_c, rf_c = _ens_calls(sub.to("cpu"))
    per_g, rf_g = _ens_calls(sub)
    torch.cuda.synchronize()
    after = _counts()
    d = {k: after[k] - before[k] for k in after}
    if any(d[f"{k}_twin"] != 1 or d[k] != 1
           for k in ("axisquantile", "betainc")):
        raise AssertionError(f"CPU run must use the twins, the card the "
                             f"kernels: {d}")
    errs = {f"p{int(v)}": _compare(f"p{int(v)} cpu vs card",
                                   per_g[float(v)].data, per_c[float(v)].data,
                                   rtol=0.0, atol=0.0) for v in ENS_VALUES}
    # float32 x = df / (df + t^2) resolves t^2 only above df * 6e-8, so a
    # p-value near 1 carries an absolute error up to ~0.8 * sqrt(181 *
    # 6e-8) = 2.6e-3 on either side; below 0.5 the relative bound holds
    pg, pc = rf_g["pvals"].data.cpu(), rf_c["pvals"].data
    high = pc >= 0.5
    errs["pvals"] = max(
        _compare("pvals < 0.5 cpu vs card", pg[~high], pc[~high],
                 rtol=P_RTOL, atol=P_ATOL),
        _compare("pvals >= 0.5 cpu vs card", pg[high], pc[high], rtol=0.0,
                 atol=P_NEAR_ONE))
    # a member whose p-value sits within P_RTOL of p_change may flip
    # `changed` and so changed_*; one within P_NEAR_ONE of 1 has |fut - hist|
    # within rounding of 0, whose sign may flip positive, negative and agree.
    # No cell is exempt from `valid`.
    near_change = ((pc - 0.05).abs() <= P_RTOL * 0.05 + P_ATOL).any(dim=0)
    near_one = (pc >= 1.0 - P_NEAR_ONE).any(dim=0)
    exempt = {"changed": near_change, "changed_positive": near_change,
              "changed_negative": near_change, "positive": near_one,
              "negative": near_one, "agree": near_one}
    # a member's p-value lies within P_NEAR_ONE of 1 with chance P_NEAR_ONE
    # when it shows no change: at most 1 - (1 - 3e-3)^30 = 8.6 % of cells
    ncell = near_one.numel()
    share = {"near_p_change": float(near_change.float().mean()),
             "near_one": float(near_one.float().mean())}
    if share["near_p_change"] >= 0.05 or share["near_one"] >= 0.10:
        raise AssertionError(f"too many exempt cells: {share}")
    for k in rf_c.keys():
        if k == "pvals":
            continue
        g, c = rf_g[k].data.cpu(), rf_c[k].data
        ok = ~exempt.get(k, torch.zeros_like(near_one))
        if not torch.equal(g[ok], c[ok]):
            raise AssertionError(f"{k}: cpu and card fractions differ")
    _log(f"[cpu twin vs card kernel] ensemble_percentiles and "
         f"robustness_fractions(ttest) on {ncell} cells: "
         f"max_abs_err {json.dumps(errs)} (percentiles value-equal, p-values "
         f"within rtol {P_RTOL} below 0.5, {P_NEAR_ONE} above); fractions "
         f"equal: valid in all cells, changed* in "
         f"{int((~near_change).sum())} ({int(near_change.sum())} exempt: a "
         f"p-value within tolerance of 0.05, bound 5 %), positive, negative "
         f"and agree in {int((~near_one).sum())} ({int(near_one.sum())} "
         f"exempt: a p-value within {P_NEAR_ONE} of 1, bound 10 %)")


SP_DAYS = 3650       # 10 noleap years from 2000-01-01 (bench.py:437)
SP_SIDES = (448, 100)  # bench.py's "spells" grids: saturated, and small
SP_CROP = 32         # side of the crop held against the CPU twins
SP_EVENT_RTOL = 1e-5  # find_events' event_sum: index_add_ on the card adds
                      # in another order (runs of a few to ~30 days)
#: launches of each config-2 call (one per kernel wrapper call): the
#: threshold count and the heat-wave runs in spells; each indicator's
#: missing-value mask counts each input's valid days in segred
SP_LAUNCHES = {
    "atmos.tx_days_above": {"spells": 1, "segred": 1},
    "atmos.heat_wave_frequency": {"spells": 1, "segred": 2},
    "indices.tx_days_above": {"spells": 1, "segred": 0},
    "indices.heat_wave_frequency": {"spells": 1, "segred": 0},
}

#: the units each call gives (the indicator's declared units, or the
#: index's to_agg_units)
SP_UNITS = {"atmos.tx_days_above": "days", "atmos.heat_wave_frequency": "1",
            "indices.tx_days_above": "d", "indices.heat_wave_frequency": ""}


def _spell_temps(device, side):
    """tasmax and tasmin as bench.py:437-439 builds them: N(290, 8) and
    N(280, 8) K from seeds 1 and 2, SP_DAYS noleap days from 2000-01-01,
    (time, side, side) float32 made on the card."""
    import numpy as np
    import torch

    from xclim_tpu_torch.core.calendar import date_range
    from xclim_tpu_torch.core.dataarray import ClimArray

    t = date_range("2000-01-01", periods=SP_DAYS, freq="D", calendar="noleap")
    coords = {"time": t, "lat": np.arange(side), "lon": np.arange(side)}
    out = []
    for seed, mu, name, cm in ((1, 290.0, "tasmax", "time: maximum"),
                               (2, 280.0, "tasmin", "time: minimum")):
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        data = torch.randn((SP_DAYS, side, side), generator=gen,
                           device=device)
        data.mul_(8.0).add_(mu)
        out.append(ClimArray(data, ("time", "lat", "lon"), coords,
                             {"units": "K", "standard_name": "air_temperature",
                              "cell_methods": cm}, name))
    return out


def _spell_calls(tx, tn):
    """The config's four public calls (bench.py:440-446: the bare indices;
    the indicators add the missing-value masks and attributes)."""
    from xclim_tpu_torch import indices
    from xclim_tpu_torch.indicators import atmos

    hw = {"thresh_tasmin": "22 degC", "thresh_tasmax": "30 degC",
          "freq": "YS"}
    return {
        "atmos.tx_days_above": lambda: atmos.tx_days_above(
            tx, thresh="25 degC", freq="YS"),
        "atmos.heat_wave_frequency": lambda: atmos.heat_wave_frequency(
            tn, tx, **hw),
        "indices.tx_days_above": lambda: indices.tx_days_above(
            tx, thresh="25 degC", freq="YS"),
        "indices.heat_wave_frequency": lambda: indices.heat_wave_frequency(
            tn, tx, **hw),
    }


def _spell_plain(tx, tn):
    """The two results by per-year expressions independent of the package
    (noleap YS periods are 365 days): the days with tasmax > 25 degC, and
    the runs of at least 3 days within a year with tasmin > 22 degC and
    tasmax > 30 degC, counted on their first day."""
    import torch

    from xclim_tpu_torch.core.units import convert_units_to, str2pint

    def k(s):
        return convert_units_to(str2pint(s), tx)

    years = SP_DAYS // 365
    days = (tx.data > k("25 degC")).reshape(years, 365, -1).sum(
        1, dtype=torch.int32)
    c = ((tn.data > k("22 degC")) & (tx.data > k("30 degC"))).reshape(
        years, 365, -1)
    first = c.clone()
    first[:, 1:] &= ~c[:, :-1]
    waves = (first[:, :-2] & c[:, 1:-1] & c[:, 2:]).sum(1, dtype=torch.int32)
    return days, waves


def phase_spells_indices(device, card, record):
    """Config 2 at bench's size: atmos.tx_days_above + heat_wave_frequency
    (and the bare indices) on 448 x 448 and 100 x 100 cells x 10 noleap
    years; launch counts, values against per-year expressions, times,
    peak memory; the two threshold_count routes side by side; spells at
    the heat-wave condition against its twin; a profile of the pair."""
    import torch

    from perfbench import roofline
    from xclim_tpu_torch.core.units import convert_units_to, str2pint
    from xclim_tpu_torch.ops import segred, spells

    crop = None
    for side in SP_SIDES:
        tx, tn = _spell_temps(device, side)
        cells = side * side
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        calls = _spell_calls(tx, tn)
        plain_days, plain_waves = _spell_plain(tx, tn)
        res = {}
        for name, fn in calls.items():
            # the main path's run: counts from zero, read right after
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _reset_counts()
            out = fn()
            torch.cuda.synchronize()
            counts = _counts()
            peak = (torch.cuda.max_memory_allocated() - base) / 2**30
            want = dict({k: 0 for k in counts}, **SP_LAUNCHES[name])
            if counts != want:
                raise AssertionError(f"{name} at {side}^2: launch counts "
                                     f"{counts}, expected {want}")
            expect = plain_days if "tx_days" in name else plain_waves
            if (tuple(out.shape) != (SP_DAYS // 365, side, side)
                    or out.data.dtype != torch.float32
                    or out.data.device != device):
                raise AssertionError(f"{name}: {tuple(out.shape)} "
                                     f"{out.data.dtype} on {out.data.device}")
            if not torch.equal(out.data.reshape(expect.shape),
                               expect.to(torch.float32)):
                raise AssertionError(f"{name} at {side}^2 differs from its "
                                     f"per-year expression")
            units = out.attrs.get("units")
            if units != SP_UNITS[name]:
                raise AssertionError(f"{name}: units {units!r}")
            mean = float(out.data.double().mean())
            del out
            sec, runs = _timed(fn)
            res[name] = sec
            launched = sorted(k for k, v in SP_LAUNCHES[name].items() if v)
            _log(f"[spells_indices] {name} ({SP_DAYS}, {side}, {side}) on "
                 f"{card}: {sec:.6f} s (median of 3 after a warm-up; runs "
                 f"{[round(v, 6) for v in runs]}), "
                 f"{SP_DAYS * cells / sec:.1f} cell-days/s, peak device "
                 f"memory above the inputs {peak:.3f} GiB (inputs "
                 f"{2 * tx.data.numel() * 4 / 2**30:.3f} GiB); launches "
                 f"{json.dumps({k: counts[k] for k in launched})}, twin "
                 f"calls 0; mean {mean:.5f}, equal to the per-year "
                 f"expression")
        for kind in ("atmos", "indices"):
            t1 = res[f"{kind}.tx_days_above"]
            t2 = res[f"{kind}.heat_wave_frequency"]
            _log(f"[spells_indices] {kind} pair at {side}^2 on {card}: mean "
                 f"of the two {SP_DAYS * cells * (1 / t1 + 1 / t2) / 2:.1f} "
                 f"cell-days/s (bench.py:447-448)")
        if side != SP_SIDES[0]:
            continue

        # threshold_count's two routes at tx_days_above's input, in turns
        spec = tx.resample("YS").spec
        x2 = tx.data.reshape(SP_DAYS, -1)
        thr = convert_units_to(str2pint("25 degC"), tx)

        def spells_route():
            return spells.spell_stats(x2, spec.starts, spec.counts, 1,
                                      op=">", thresh=thr)[0]

        def segred_route():
            return segred.segment_reduce_onepass(
                (x2 > thr).to(torch.float32), spec.starts, spec.counts,
                "sum")

        if not torch.equal(spells_route(), segred_route()):
            raise AssertionError("threshold_count routes disagree")
        times = {"spells": [], "segred": []}
        for route in ("spells", "segred", "segred", "spells"):
            fn = spells_route if route == "spells" else segred_route
            times[route].append(_cuda_ms(fn, 10))
        nbytes = x2.numel() * 4
        out_bytes = spec.nseg * x2.shape[1] * 4
        traffic = {"spells": nbytes + 4 * out_bytes,
                   "segred": nbytes + 2 * x2.numel() + 2 * nbytes + out_bytes}
        fbound = roofline.bound(nbytes + out_bytes, x2.numel())
        for route, ms in times.items():
            _log(f"[spells_indices] threshold_count route {route} at "
                 f"({SP_DAYS}, {cells}) YS '>' on {card}: runs "
                 f"{[round(v, 4) for v in ms]} ms; moves "
                 f"{traffic[route] / 1e9:.3f} GB "
                 f"({traffic[route] / roofline.HBM_BYTES_S * 1e3:.4f} ms at "
                 f"3.35 TB/s); the count's own bound {fbound['bound_ms']:.4f} ms "
                 f"({fbound['bound_by']})")
        other = {"spells": "segred", "segred": "spells"}
        faster = [r for r in times if max(times[r]) < min(times[other[r]])]
        _log(f"[spells_indices] threshold_count: faster in both runs: "
             f"{faster[0] if faster else 'neither'}")

        # spells at heat_wave_frequency's bool condition against its twin
        t1 = convert_units_to(str2pint("22 degC"), tn)
        t2 = convert_units_to(str2pint("30 degC"), tx)
        cond = ((tn.data > t1) & (tx.data > t2)).reshape(SP_DAYS, -1)
        got = spells.spell_stats(cond, spec.starts, spec.counts, 3)
        ref = spells.spell_stats_plain(cond, spec.starts, spec.counts, 3)
        err = max(_compare(f"spells heat-wave condition {k}", g, r,
                           rtol=0.0, atol=0.0)
                  for k, g, r in zip(("cnt", "wrc", "wre", "lng"), got, ref))
        del got, ref
        ms = _cuda_ms(lambda: spells.spell_stats(cond, spec.starts,
                                                 spec.counts, 3), 10)
        pms = _cuda_ms(lambda: spells.spell_stats_plain(
            cond, spec.starts, spec.counts, 3), 2)
        hb = roofline.bound(cond.numel() + 4 * out_bytes, cond.numel())
        record["spells"]["max_abs_err"] = max(record["spells"]["max_abs_err"],
                                              err)
        _log(f"[kernel vs twin] spells at heat_wave_frequency's bool "
             f"condition {tuple(cond.shape)} YS window 3 on {card}: "
             f"max_abs_err={err} kernel_ms={ms:.4f} twin_ms={pms:.4f} "
             f"bound_ms={hb['bound_ms']:.4f} ({hb['bound_by']})")
        del cond
        _profile(f"config 2 pair atmos.tx_days_above + "
                 f"atmos.heat_wave_frequency ({SP_DAYS}, {side}, {side})",
                 lambda: [fn() for k, fn in calls.items()
                          if k.startswith("atmos")], card)
        crop = (tx.isel(lat=slice(0, SP_CROP), lon=slice(0, SP_CROP)),
                tn.isel(lat=slice(0, SP_CROP), lon=slice(0, SP_CROP)))
        crop = tuple(c.copy(data=c.data.contiguous()) for c in crop)
        del tx, tn, calls, x2
        torch.cuda.empty_cache()
    return crop


def phase_spells_indices_cpu_vs_card(crop):
    """The config's calls and their neighbours on a 32 x 32 crop: CPU
    tensors (the twins) against the card (the kernels). Counts, lengths and
    days of year value-equal; growing degree days within RTOL; find_events'
    event_sum within SP_EVENT_RTOL."""
    import warnings

    import torch

    from xclim_tpu_torch.indicators import atmos
    from xclim_tpu_torch.indices import run_length

    tx, tn = crop
    tg = tn.copy()
    tg.attrs["cell_methods"] = "time: mean"
    low = {"thresh_tasmin": "15 degC", "thresh_tasmax": "25 degC"}
    calls = {
        "atmos.tx_days_above": lambda x, n, g: atmos.tx_days_above(
            x, thresh="25 degC", freq="YS"),
        "atmos.heat_wave_frequency": lambda x, n, g: atmos.heat_wave_frequency(
            n, x, thresh_tasmin="22 degC", thresh_tasmax="30 degC",
            freq="YS"),
        "atmos.heat_wave_frequency (15/25 degC)":
            lambda x, n, g: atmos.heat_wave_frequency(n, x, **low),
        "atmos.hot_spell_frequency": lambda x, n, g: atmos.hot_spell_frequency(
            x, thresh="25 degC"),
        "atmos.heat_wave_max_length": lambda x, n, g: atmos.heat_wave_max_length(
            n, x, window=1, **low),
        "atmos.maximum_consecutive_frost_days":
            lambda x, n, g: atmos.maximum_consecutive_frost_days(n),
        "atmos.growing_season_length": lambda x, n, g: atmos.growing_season_length(
            g, thresh="10 degC"),
        "atmos.frost_free_season_start":
            lambda x, n, g: atmos.frost_free_season_start(n),
        "atmos.growing_degree_days": lambda x, n, g: atmos.growing_degree_days(
            g, thresh="7 degC"),
    }
    errs = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for name, fn in calls.items():
            cpu_in = [a.to("cpu") for a in (tx, tn, tg)]
            before = _counts()
            out_c = fn(*cpu_in)
            mid = _counts()
            out_g = fn(tx, tn, tg)
            torch.cuda.synchronize()
            after = _counts()
            on_cpu = {k: mid[k] - before[k] for k in after}
            on_card = {k: after[k] - mid[k] for k in after}
            if (on_cpu["spells"] or on_cpu["segred"] or on_card["spells_twin"]
                    or on_card["segred_twin"]
                    or not (on_card["spells"] or on_card["segred"])):
                raise AssertionError(f"{name}: the CPU run must use the "
                                     f"twins, the card the kernels: "
                                     f"{on_cpu} then {on_card}")
            rtol = RTOL if "degree_days" in name else 0.0
            errs[name] = _compare(f"{name} cpu vs card", out_g.data,
                                  out_c.data, rtol=rtol, atol=0.0)
            ga = {k: v for k, v in out_g.attrs.items() if k != "history"}
            ca = {k: v for k, v in out_c.attrs.items() if k != "history"}
            if ga != ca or out_g.dims != out_c.dims:
                raise AssertionError(f"{name}: attrs differ: {ga} vs {ca}")
        cond = tx > 298.15
        before = _counts()
        ev_c = run_length.find_events(cond.to("cpu"), 3, data=tx.to("cpu"),
                                      freq="YS")
        ev_g = run_length.find_events(cond, 3, data=tx, freq="YS")
        torch.cuda.synchronize()
        if _counts() != before:
            raise AssertionError("find_events called a kernel wrapper")
    for k in ev_c:
        errs[f"find_events {k}"] = _compare(
            f"find_events {k} cpu vs card", ev_g[k].data, ev_c[k].data,
            rtol=SP_EVENT_RTOL if k == "event_sum" else 0.0, atol=0.0)
    _log(f"[cpu twins vs card kernels] config 2 and its neighbours on "
         f"{SP_CROP}x{SP_CROP} cells: max_abs_err {json.dumps(errs)} (counts, "
         f"lengths and days of year value-equal; growing_degree_days within "
         f"rtol {RTOL}; event_sum within rtol {SP_EVENT_RTOL}); attrs equal")


DQM_TREND = 0.03     # K a year planted in DQM's sim
DQM_TREND_TOL = 0.005  # K a year: |trend(scen) - trend(sim)| per cell
DQM_CROP = 32        # side of the crop held against the CPU twins
#: DQM CPU twins vs card kernels: scaling is a difference of two ~290 K
#: window means (1e-6 of each, absolute), which hist_q (quantiles of the
#: scaled hist) and af carry; scen as in
#: tests/test_torch_sdba_methods.py (a value 1 ulp off can cross the two
#: end nodes, whose af slope reaches ~10)
DQM_ATOL_K = 6e-4
DQM_SCEN_RTOL = 2e-5
#: rest of sdba, CPU twins vs card: the same float32 ops with sums in
#: another order (means of ~1000-10950 values, Sinkhorn's logsumexp)
REST_RTOL = 1e-5
REST_ATOL = 2e-5
#: (call, output) -> (rtol, atol) where that does not hold: measures.bias
#: of two ~290 K means, each within 1e-6 relative: 2 x 1e-6 x 300 K
REST_TOL = {("properties + measures on DQM's scen", 5): (0.0, 6e-4)}
NPDF_DAYS = 10950
NPDF_ITER = 20
OTC_POINTS = 2048
REST_CROP = 16       # side of the crops held against the CPU runs
GEV_CROP = 64        # the ML fit's crop: its disagreements are counted


def _dqm_series(device):
    """QDM's series (``_series``) with +DQM_TREND K a year added to a copy
    of sim, so that DQM's detrend has work."""
    import torch

    series = _series(device, (SIDE, SIDE))
    sim = series["sim"]
    years = torch.as_tensor(sim.time.decimal_year - sim.time.decimal_year[0],
                            dtype=torch.float32, device=device)
    series["sim"] = sim.copy(data=sim.data + DQM_TREND * years[:, None, None])
    return series


def _dqm_train(series):
    from xclim_tpu_torch.sdba import DetrendedQuantileMapping, Grouper

    return DetrendedQuantileMapping.train(
        series["ref"], series["hist"], group=Grouper("time.dayofyear", WINDOW),
        nquantiles=NQ, kind="+")


def _dqm(series):
    adj = _dqm_train(series)
    return adj, adj.adjust(series["sim"])


def _slopes(da):
    """(cells,) least-squares slope over decimal years (per year), NaNs
    skipped, float64."""
    import torch

    x = da.data.reshape(da.shape[0], -1).double()
    t = torch.as_tensor(da.time.decimal_year, dtype=torch.float64,
                        device=x.device)[:, None]
    ok = ~torch.isnan(x)
    n = ok.sum(0)
    tm = torch.where(ok, t, 0.0).sum(0) / n
    xm = torch.where(ok, x, 0.0).sum(0) / n
    cov = torch.where(ok, (t - tm) * (x - xm), 0.0).sum(0)
    return cov / torch.where(ok, (t - tm) ** 2, 0.0).sum(0)


def phase_dqm(device, card, record):
    """DQM at config 4's width: train on ref and hist, adjust a sim with a
    planted trend; launch counts, finiteness, the trend kept, times, peak
    memory; winquantile held against its twin at the scaled hist, eqmadjust
    at sim."""
    import torch

    from perfbench import roofline
    from xclim_tpu_torch.ops import eqmadjust, winquantile
    from xclim_tpu_torch.sdba import Grouper
    from xclim_tpu_torch.sdba.adjustment import _apply_kind
    from xclim_tpu_torch.sdba.utils import gather_doy_slices

    series = _dqm_series(device)
    T = series["sim"].shape[0]
    cells = SIDE * SIDE
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()

    # the main path's run: counts from zero, read right after the train
    _reset_counts()
    adj, out = _dqm(series)
    torch.cuda.synchronize()
    counts = _counts()
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    _log(f"[dqm] launch counts of one DQM train+adjust at {cells} cells: "
         f"{json.dumps(counts)}")
    if counts != dict({k: 0 for k in counts}, winquantile=2, eqmadjust=1,
                      eqmadjust_shared=1):
        raise AssertionError(f"DQM did not run on the kernels: {counts}")
    record["winquantile"]["paths"]["dqm train"] = counts["winquantile"]
    record["eqmadjust"]["paths"]["dqm adjust"] = counts["eqmadjust"]
    record["eqmadjust"]["launches"] = counts["eqmadjust"]

    sim = series["sim"].data
    if tuple(out.shape) != tuple(sim.shape) or out.data.device != device:
        raise AssertionError(f"DQM output {tuple(out.shape)} on "
                             f"{out.data.device}")
    if not torch.equal(torch.isfinite(out.data), torch.isfinite(sim)):
        raise AssertionError("DQM output is not finite exactly where sim is")
    s_sim, s_scen = _slopes(series["sim"]), _slopes(out)
    dev = (s_scen - s_sim).abs()
    mean = float(out.data.double().mean())
    _log(f"[dqm] per-cell trend: sim {float(s_sim.mean()):.5f} K/yr "
         f"(planted {DQM_TREND}), scen {float(s_scen.mean()):.5f} K/yr, "
         f"|scen - sim| max {float(dev.max()):.6f} K/yr (tolerance "
         f"{DQM_TREND_TOL}); scen mean {mean:.4f} K (expect ~287.04: sim's "
         f"289.45 K scaled by -2 K, then mapped from N(285, 6) onto ref's "
         f"N(285, 5): 285 + 5/6 x 2.45)")
    if float(dev.max()) > DQM_TREND_TOL or abs(mean - 287.04) > 0.3:
        raise AssertionError("DQM did not keep sim's trend")

    # winquantile against its twin at DQM's scaled hist (the second launch)
    hist = series["hist"]
    grp = Grouper("time.dayofyear", WINDOW)
    gid = torch.as_tensor(grp.group_of_step(hist.time).astype("int64"),
                          device=device)
    xh = _apply_kind(hist.data, adj.ds["scaling"][gid], "+")
    xd = gather_doy_slices(xh, grp.device_doy_table(hist.time, device))
    xd = xd.reshape(xd.shape[0], xd.shape[1], -1)
    q = adj.ds["quantiles"].astype("float32")
    err = _compare(f"winquantile at DQM's scaled hist {tuple(xd.shape)}",
                   winquantile.doy_window_quantiles(xd, q, WINDOW),
                   winquantile.doy_window_quantiles_plain(xd, q, WINDOW),
                   rtol=0.0, atol=0.0)
    record["winquantile"]["max_abs_err"] = max(
        record["winquantile"]["max_abs_err"], err)
    del xh, xd

    # eqmadjust against its twin at the trained state, on sim itself (the
    # adjust runs it on the detrended sim: the same shapes)
    table = grp.device_adjust_table(series["sim"].time, device)[0]
    xf2 = sim.reshape(T, -1)
    hq, af = (adj.ds[k].reshape(adj.ds[k].shape[0], adj.ds[k].shape[1], -1)
              for k in ("hist_q", "af"))
    args = (xf2, table, hq, af)
    err = _compare(f"eqmadjust at DQM's series {tuple(xf2.shape)}",
                   eqmadjust.eqm_adjust_series(*args),
                   eqmadjust.eqm_adjust_series_plain(*args), rtol=0.0,
                   atol=0.0)
    ms = _cuda_ms(lambda: eqmadjust.eqm_adjust_series(*args), 10)
    pms = _cuda_ms(lambda: eqmadjust.eqm_adjust_series_plain(*args), 1)
    # bound: the series, the table, hist_q and af read once, the result
    # written once; operations: each value against each node
    record["eqmadjust"].update(
        max_abs_err=err, ms=ms, plain_ms=pms,
        **roofline.bound((2 * xf2.numel() + hq.numel() + af.numel()) * 4
                         + table.numel() * 8, float(xf2.numel() * hq.shape[1])))
    _log(f"[kernel vs twin] eqmadjust at DQM's series {tuple(xf2.shape)} "
         f"through a {tuple(table.shape)} table, {hq.shape[1]} nodes on "
         f"{card}: value-equal; kernel_ms={ms:.3f} twin_ms={pms:.3f} "
         f"bound_ms={record['eqmadjust']['bound_ms']:.4f}")
    del args, xf2, hq, af

    train_s, adjust_s = [], []
    for _ in range(4):   # a warm-up, then 3
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        a = _dqm_train(series)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        a.adjust(series["sim"])
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        train_s.append(t1 - t0)
        adjust_s.append(t2 - t1)
    tr, ad = statistics.median(train_s[1:]), statistics.median(adjust_s[1:])
    _log(f"[dqm] DQM doy w{WINDOW} nq{NQ} {cells} cells {YEARS}y on {card}: "
         f"train {tr:.4f} s, adjust {ad:.4f} s (median of 3 after a warm-up;"
         f" train runs {[round(v, 4) for v in train_s[1:]]}, adjust runs "
         f"{[round(v, 4) for v in adjust_s[1:]]}), "
         f"{T * cells / (tr + ad):.1f} cell-days/s, peak device memory above "
         f"the inputs {peak:.3f} GiB (inputs "
         f"{3 * sim.numel() * 4 / 2**30:.3f} GiB); winquantile at the scaled "
         f"hist value-equal to its twin")
    _profile(f"DQM adjust ({T}, {SIDE}, {SIDE})",
             lambda: adj.adjust(series["sim"]), card)
    return series, out


def phase_dqm_cpu_vs_card(full):
    """DQM on a 32 x 32 crop: CPU tensors (the twins) against the card (the
    kernels); af, hist_q, scaling and scen compared."""
    import torch

    crop = {k: v.isel(lat=slice(0, DQM_CROP), lon=slice(0, DQM_CROP))
            for k, v in full.items()}
    crop = {k: v.copy(data=v.data.contiguous()) for k, v in crop.items()}
    before = _counts()
    adj_c, out_c = _dqm({k: v.to("cpu") for k, v in crop.items()})
    adj_g, out_g = _dqm(crop)
    torch.cuda.synchronize()
    after = _counts()
    d = {k: after[k] - before[k] for k in after}
    if d != dict({k: 0 for k in d}, winquantile=2, winquantile_twin=2,
                 eqmadjust=1, eqmadjust_twin=1, eqmadjust_shared=1):
        raise AssertionError(f"CPU run must use the twins, the card the "
                             f"kernels: {d}")
    errs = {
        "hist_q": _compare("DQM hist_q cpu vs card", adj_g.ds["hist_q"],
                           adj_c.ds["hist_q"], rtol=0.0, atol=DQM_ATOL_K),
        "scaling": _compare("DQM scaling cpu vs card", adj_g.ds["scaling"],
                            adj_c.ds["scaling"], rtol=0.0, atol=DQM_ATOL_K),
        "af": _compare("DQM af cpu vs card", adj_g.ds["af"], adj_c.ds["af"],
                       rtol=0.0, atol=DQM_ATOL_K),
        "scen": _compare("DQM scen cpu vs card", out_g.data, out_c.data,
                         rtol=DQM_SCEN_RTOL, atol=0.0)}
    _log(f"[cpu twins vs card kernels] DQM {DQM_CROP}x{DQM_CROP} cells: "
         f"max_abs_err {json.dumps(errs)} (hist_q, scaling and af within "
         f"{DQM_ATOL_K} K; scen within rtol "
         f"{DQM_SCEN_RTOL})")


def _pr(device, side, years=YEARS):
    """ref, hist, sim: daily precipitation in mm/d on (time, lat, lon), 30
    noleap years, exponential (gamma with shape 1) wet days of mean 4, 3
    and 3.5 mm/d with 55, 45 and 45 % dry days, from one seeded generator."""
    import torch

    from xclim_tpu_torch.core.calendar import date_range
    from xclim_tpu_torch.core.dataarray import ClimArray

    t = date_range("1981-01-01", periods=years * 365, freq="D",
                   calendar="noleap")
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 1)
    shape = (len(t), side, side)
    coords = {"time": t, "lat": list(range(side)), "lon": list(range(side))}
    out = {}
    for name, dry, mean in (("ref", 0.55, 4.0), ("hist", 0.45, 3.0),
                            ("sim", 0.45, 3.5)):
        u = torch.rand(shape, generator=gen, device=device)
        w = torch.rand(shape, generator=gen, device=device)
        data = torch.where(u < dry, 0.0, -mean * torch.log1p(-w))
        out[name] = ClimArray(data, ("time", "lat", "lon"), coords,
                              {"units": "mm/d",
                               "standard_name": "precipitation_flux"}, name)
    return out


def _crop(arrays):
    return {k: v.copy(data=v.data[:, :REST_CROP, :REST_CROP].contiguous())
            for k, v in arrays.items()}


def _jittered(pr):
    """pr with its dry days jittered under 0.01 mm/d (one seeded generator
    per variable, on pr's device)."""
    import torch

    from xclim_tpu_torch.sdba import processing

    return {k: processing.jitter_under_thresh(
        v, "0.01 mm/d", generator=torch.Generator(
            device=v.data.device).manual_seed(SEED + i))
        for i, (k, v) in enumerate(pr.items())}


def _rest_calls(pr, jit, tas_scen, tas_ref):
    """The rest-of-sdba calls at their sizes: name -> fn() returning a
    tensor (or a tuple of tensors); pr, its jittered copy and the
    temperatures may be the full arrays or crops, on either device."""
    import xclim_tpu_torch.sdba as sdba
    from xclim_tpu_torch.indices import stats
    from xclim_tpu_torch.sdba import measures, properties

    month = sdba.Grouper("time.month")

    def scaling():
        adj = sdba.Scaling.train(pr["ref"], pr["hist"], group=month, kind="*")
        return adj.ds["af"], adj.adjust(pr["sim"]).data

    def loci():
        adj = sdba.LOCI.train(pr["ref"], pr["hist"], group=month,
                              thresh="1 mm/d")
        return adj.ds["af"], adj.ds["hist_thresh"], adj.adjust(pr["sim"]).data

    def extremes():
        # the user recipe: a QDM doy first pass (multiplicative) on the
        # jittered series, then the GPD transfer of the extremes
        qdm = sdba.QuantileDeltaMapping.train(
            jit["ref"], jit["hist"], group=sdba.Grouper("time.dayofyear",
                                                        WINDOW),
            nquantiles=NQ, kind="*")
        scen = qdm.adjust(jit["sim"])
        ev = sdba.ExtremeValues.train(pr["ref"], pr["hist"],
                                      cluster_thresh="1 mm/d", q_thresh=0.95)
        out = ev.adjust(scen, pr["sim"], frac=0.25, power=1.0)
        return (ev.ds["k_hist"], ev.ds["s_hist"], ev.ds["thresh_hist"],
                out.data, *_ev_conditioning(ev, scen, pr["sim"]))

    def props():
        return (properties.mean(tas_scen).data,
                properties.quantile(tas_scen, q=0.98).data,
                properties.acf(tas_scen, lag=1, group="time.season").data,
                properties.spell_length_distribution(
                    tas_scen, op=">=", thresh="295 K", stat="mean").data,
                properties.return_value(tas_scen, period=20, op="max").data,
                measures.bias(properties.mean(tas_scen),
                              properties.mean(tas_ref)).data,
                measures.rmse(tas_scen, tas_ref).data)

    def gev_fit():
        amax = tas_scen.resample("YS").max()
        return amax.data, stats.fit(amax, "genextreme", method="ML").data

    return {"Scaling time.month": scaling, "LOCI time.month": loci,
            "ExtremeValues on the QDM scen": extremes,
            "properties + measures on DQM's scen": props,
            "stats.fit genextreme ML (batched BFGS)": gev_fit}


def _npdf_otc_calls(gen_dev):
    """npdf_transform (3 x 10950, 20 rotations, drawn once and handed to
    both devices) and OTC/dOTC at 2048 points x 3 variables, on tensors of
    one seeded draw: name -> fn(device, n) returning tensors (n: the
    first n steps; the sizes above by default)."""
    import numpy as np
    import torch

    import xclim_tpu_torch.sdba as sdba
    from xclim_tpu_torch.core.calendar import date_range
    from xclim_tpu_torch.core.dataarray import ClimArray
    from xclim_tpu_torch.sdba.adjustment import random_rotation_matrices

    rng = np.random.default_rng(SEED)
    L = np.linalg.cholesky(np.array([[1.0, 0.6, 0.3], [0.6, 1.0, 0.5],
                                     [0.3, 0.5, 1.0]]))
    mats = {"ref": L @ rng.normal(0, 1, (3, NPDF_DAYS)),
            "hist": rng.normal(0.2, 1.1, (3, NPDF_DAYS)),
            "sim": rng.normal(0.5, 1.2, (3, NPDF_DAYS))}
    mats = {k: np.abs(v).astype(np.float32) + 0.5 for k, v in mats.items()}
    rots = random_rotation_matrices(
        torch.Generator(device=gen_dev).manual_seed(SEED), NPDF_ITER, 3)

    def mv(device, n):
        t = date_range("1981-01-01", periods=n, calendar="noleap")
        return {k: ClimArray(torch.as_tensor(v[:, :n], device=device),
                             ("multivar", "time"),
                             {"time": t, "multivar": np.array(["a", "b", "c"])},
                             {"units": ""}, k) for k, v in mats.items()}

    def npdf(device, n=NPDF_DAYS):
        a = mv(device, n)
        ha, sa = sdba.npdf_transform(a["ref"], a["hist"], a["sim"],
                                     n_iter=NPDF_ITER, nquantiles=NQ,
                                     rotations=rots.cpu().numpy())
        return ha.data, sa.data

    def otc(device, n=OTC_POINTS):
        a = mv(device, n)
        return (sdba.OTC.adjust(a["ref"], a["hist"]).data,
                sdba.dOTC.adjust(a["ref"], a["hist"], a["sim"]).data,
                sdba.dOTC.adjust(a["ref"], a["hist"], a["sim"],
                                 kind="*").data)

    return {"npdf_transform 3 x 10950, 20 rotations": npdf,
            "OTC + dOTC (+, *) 2048 points x 3": otc}


def _as_tuple(v):
    return v if isinstance(v, tuple) else (v,)


def phase_sdba_rest(device, card, dqm_series, dqm_scen, record):
    """The rest of sdba at the sizes users run (16384 cells x 30 years; 3
    variables x 10950 days; 2048 points): one card call each, timed, then
    held against the same call on a crop as CPU tensors."""
    import torch

    pr = _pr(device, SIDE)
    jit = _jittered(pr)
    scen = dqm_series["sim"].copy(data=dqm_scen.data)
    ref = dqm_series["ref"]
    calls = _rest_calls(pr, jit, scen, ref)
    cpu = {k: v.to("cpu") for k, v in _crop(pr).items()}
    crop_c = _rest_calls(cpu, {k: v.to("cpu") for k, v in _crop(jit).items()},
                         _crop({"s": scen})["s"].to("cpu"),
                         _crop({"r": ref})["r"].to("cpu"))
    for name, fn in calls.items():
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        out = _as_tuple(fn())
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        counts = {k: v for k, v in _counts().items() if v}
        if any(k.endswith("_twin") for k in counts):
            raise AssertionError(f"{name} on the card called a twin: {counts}")
        for k, v in counts.items():
            if k in record:
                record[k]["paths"][name] = v
        side = GEV_CROP if name.startswith("stats.fit") else REST_CROP
        got = [g[..., :side, :side].cpu() for g in out]
        del out
        if name.startswith("stats.fit"):
            errs = [_gev_fits_agree(name, got, scen.copy(
                data=scen.data[:, :side, :side].contiguous()).to("cpu"))]
        elif name.startswith("ExtremeValues"):
            errs = _ev_outputs_agree(name, got, _as_tuple(crop_c[name]()))
        else:
            errs = [_compare(f"{name} [{i}] cpu vs card", g, c,
                             *REST_TOL.get((name, i), (REST_RTOL, REST_ATOL)))
                    for i, (g, c) in enumerate(zip(got, _as_tuple(
                        crop_c[name]())))]
        if not all(bool(torch.isfinite(g).any()) for g in got):
            raise AssertionError(f"{name}: an output with no finite value")
        _log(f"[sdba_rest] {name} at {tuple(pr['sim'].shape)} on {card}: "
             f"{sec:.4f} s (one call); launches {json.dumps(counts)}; "
             f"{side}x{side} crop: CPU run max_abs_err "
             f"{[round(e, 8) for e in errs]}")
    del pr, jit, calls, crop_c
    torch.cuda.empty_cache()

    for name, fn in _npdf_otc_calls(device).items():
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        fn(device)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        counts = {k: v for k, v in _counts().items() if v}
        # OTC's plans at 2048 points take minutes on the CPU: the crop is
        # the first 256 points, run on both devices
        n = NPDF_DAYS if name.startswith("npdf") else 256
        got = _as_tuple(fn(device, n))
        want = _as_tuple(fn("cpu", n))
        errs = []
        for i, (g, c) in enumerate(zip(got, want)):
            if name.startswith("npdf"):
                # 20 rounds of rotate -> QDM over 10950 ranks: two rotated
                # values within an ulp may swap ranks on one device
                # (tests/test_torch_sdba_methods.py): under 1 % of values
                # off by more than 1e-4, none by more than 1e-2
                e = (g.cpu() - c).abs()
                if float((e > 1e-4).double().mean()) >= 0.01 or \
                        float(e.max()) > 1e-2:
                    raise AssertionError(f"{name} [{i}] cpu vs card: "
                                         f"max {float(e.max())}")
                errs.append(float(e.max()))
            else:
                errs.append(_compare(f"{name} [{i}] cpu vs card", g, c,
                                     rtol=REST_RTOL, atol=REST_ATOL))
        _log(f"[sdba_rest] {name} on {card}: {sec:.4f} s (one call); "
             f"launches {json.dumps(counts)}; CPU run at {n} steps max_abs_err "
             f"{[round(e, 8) for e in errs]}")


def _ev_conditioning(ev, scen, sim):
    """(ph, bound) for ExtremeValues' blend out = (1 - w) scen + w T,
    w = clip((ph - 0.75) / 0.25, 0, 1), T = thresh_ref + s_ref / k_ref
    (1 - (1 - ph)^k_ref), ph = 1 - (1 - k_hist y / s_hist)^(1 / k_hist):
    hist's GPD cdf of sim, and how far float32 rounding moves out when
    each pow rounds a few ulp apart (two devices' pow and exp do). The
    error of 1 - ph is 4 ulp of 1 plus 4 ulp of itself over |k_hist|
    (the 1 / k power); the weight turns it into |T - scen| / 0.25 of
    output and T into s_ref (1 - ph)^(k_ref - 1) of T; T's own difference
    1 - (1 - ph)^k_ref cancels to 4 ulp of 1 over |k_ref| / s_ref."""
    import torch

    from xclim_tpu_torch.sdba.adjustment import _gpd_cdf, _gpd_ppf

    d = {k: v.double() for k, v in ev.ds.items()}
    ph = _gpd_cdf(torch.clamp(sim.data - ev.ds["thresh_hist"], min=0.0),
                  ev.ds["k_hist"], ev.ds["s_hist"]).double()
    T = d["thresh_ref"] + _gpd_ppf(ph, d["k_ref"], d["s_ref"])
    ulp4 = 4 * 2.0 ** -23
    tail = 1 - torch.clamp(ph, 1e-9, 1 - 1e-9)
    d1p = ulp4 + ulp4 * tail / torch.clamp(d["k_hist"].abs(), max=1.0)
    dT = (d["s_ref"] * tail ** (d["k_ref"] - 1) * d1p
          + ulp4 * (d["s_ref"] / d["k_ref"]).abs())
    return ph, (T - scen.data.double()).abs() / 0.25 * d1p + dT


def _ev_outputs_agree(name, got, want) -> list:
    """ExtremeValues' fit (k, sigma, POT level) within REST_RTOL; its
    blended output within REST_RTOL plus the float32 conditioning of the
    reference's formula (:func:`_ev_conditioning`). Where ph rounds to
    within 1e-6 of 1 (the far tail), float32 holds too few bits of 1 - ph
    for T to be determined (it reaches inf, on the reference too): those
    values are counted, and their NaN/inf pattern only is compared."""
    import torch

    errs = [_compare(f"{name} [{i}] cpu vs card", g, c, rtol=REST_RTOL,
                     atol=REST_ATOL)
            for i, (g, c) in enumerate(zip(got[:3], want[:3]))]
    g, c, ph, cond = got[3], want[3], want[4], want[5]
    tail = ph > 1 - 1e-6
    if not torch.equal(torch.isinf(g) | torch.isnan(g),
                       torch.isinf(c) | torch.isnan(c)):
        raise AssertionError(f"{name}: inf/NaN patterns differ")
    ok = ~tail & torch.isfinite(c)
    err = (g - c).abs()[ok].double()
    bound = (REST_ATOL + REST_RTOL * c.abs().double() + cond)[ok]
    if bool((err > bound).any()):
        raise AssertionError(f"{name}: {int((err > bound).sum())} values "
                             f"beyond the bound, max abs err "
                             f"{float(err.max())}")
    _log(f"[sdba_rest] {name}: {int(tail.sum())} of {tail.numel()} crop "
         f"values in the far tail (ph > 1 - 1e-6; "
         f"{int(torch.isinf(c).sum())} inf on both devices); largest "
         f"conditioning term of the bound {float(cond[ok].max())}, max "
         f"err / bound {float((err / bound).max())}")
    return errs + [float(err.max())]


def _gev_fits_agree(name, got, scen_cpu) -> float:
    """The card's ML fits against the CPU's on the crop. The block maxima
    are value-equal (segred against its twin). A float32 BFGS on 30
    maxima is ill-conditioned where the likelihood is flat or unbounded
    (a shape near 0, or outside (-1, 1) with a maximum at the support's
    edge): there a one-ulp change of the data moves the optimum by more
    than the reference's ML tolerance. So the fits disagreeing beyond
    1e-3 (c by 1e-3 (1 + |c|), loc and scale relative) on the two devices
    must be no more than twice those that disagree on the CPU between the
    maxima and the maxima scaled by 1 + 2^-23, plus 0.1 % of the cells.
    Returns the largest parameter difference."""
    import torch

    from xclim_tpu_torch.indices import stats

    amax = scen_cpu.resample("YS").max()
    _compare(f"{name} block maxima cpu vs card", got[0], amax.data,
             rtol=0.0, atol=0.0)
    p_cpu = stats.fit(amax, "genextreme", method="ML").data
    p_ulp = stats.fit(amax.copy(data=amax.data * (1 + 2.0 ** -23)),
                      "genextreme", method="ML").data
    p_card = got[1]

    def disagree(a, b):
        d = (a - b).abs()
        return ((d[0] > 1e-3 * (1 + a[0].abs())) | (d[1] > 1e-3 * a[1].abs())
                | (d[2] > 1e-3 * a[2].abs()))

    if not torch.equal(torch.isfinite(p_card), torch.isfinite(p_cpu)):
        raise AssertionError(f"{name}: finite patterns differ")
    n_dev = int(disagree(p_cpu, p_card).sum())
    n_ulp = int(disagree(p_cpu, p_ulp).sum())
    cells = p_cpu[0].numel()
    _log(f"[sdba_rest] {name}: {n_dev} of {cells} cells disagree beyond "
         f"1e-3 between the devices; {n_ulp} between the CPU fit of the "
         f"maxima and of the maxima one ulp up; shape c in "
         f"[{float(p_cpu[0].min()):.3f}, {float(p_cpu[0].max()):.3f}]")
    if n_dev > 2 * n_ulp + cells // 1000:
        raise AssertionError(f"{name}: {n_dev} fits disagree between the "
                             f"devices, {n_ulp} under a one-ulp change")
    return float((p_card - p_cpu).abs().max())


CH_DAYS = 3650        # 10 noleap years from 2000-01-01 (bench.py:556)
CH_SIDES = (320, 100)  # bench.py's fused-chain rows: saturated, and small
CH_CROP = 32          # side of the crop held against the CPU twins
#: bench.py:565-578: the chain's registry steps (key, input, keywords)
CH_STEPS = (("TG_MEAN", "tas", {"freq": "MS"}),
            ("TX_DAYS_ABOVE", "tasmax", {"thresh": "25 degC", "freq": "YS"}),
            ("FROST_DAYS", "tasmin", {"freq": "YS"}),
            ("ICE_DAYS", "tasmax", {"freq": "YS"}),
            ("GROWING_DEGREE_DAYS", "tas", {"thresh": "4 degC",
                                            "freq": "YS"}),
            ("HEATING_DEGREE_DAYS", "tas", {"thresh": "17 degC",
                                            "freq": "YS"}),
            ("COOLING_DEGREE_DAYS", "tas", {"thresh": "18 degC",
                                            "freq": "YS"}),
            ("HEAT_WAVE_INDEX", "tasmax", {"freq": "YS"}),
            ("CDD", "pr", {"freq": "YS"}),
            ("PRCPTOT", "pr", {"freq": "YS"}))
CH_VARS = ("tas", "tasmax", "tasmin", "pr")
#: launches of each step on the card (one per kernel wrapper call): the
#: sums and means through segred, the day counts and runs of a scalar
#: threshold through spells; each indicator's missing-value mask counts
#: its input's valid days in segred once
CH_LAUNCHES = {"TG_MEAN": {"segred": 2},
               "TX_DAYS_ABOVE": {"spells": 1, "segred": 1},
               "FROST_DAYS": {"spells": 1, "segred": 1},
               "ICE_DAYS": {"spells": 1, "segred": 1},
               "GROWING_DEGREE_DAYS": {"segred": 2},
               "HEATING_DEGREE_DAYS": {"segred": 2},
               "COOLING_DEGREE_DAYS": {"segred": 2},
               "HEAT_WAVE_INDEX": {"spells": 1, "segred": 1},
               "CDD": {"spells": 1, "segred": 1},
               "PRCPTOT": {"segred": 2}}


def _chain_inputs(device, side):
    """The chain's four inputs as bench.py's cfg_fused_chain builds them
    (bench.py:556-563): tas N(285, 6), tasmax N(291, 6), tasmin N(279, 6)
    K and pr |N(3e-5, 2e-5)| kg m-2 s-1, from seeds 20-23, CH_DAYS noleap
    days from 2000-01-01, (time, side, side) float32 made on the card."""
    import numpy as np
    import torch

    from xclim_tpu_torch.core.calendar import date_range
    from xclim_tpu_torch.core.dataarray import ClimArray

    t = date_range("2000-01-01", periods=CH_DAYS, freq="D", calendar="noleap")
    coords = {"time": t, "lat": np.arange(side), "lon": np.arange(side)}
    out = {}
    for seed, (name, mu, sd, units) in zip(range(20, 24), (
            ("tas", 285.0, 6.0, "K"), ("tasmax", 291.0, 6.0, "K"),
            ("tasmin", 279.0, 6.0, "K"), ("pr", 3e-5, 2e-5, "kg m-2 s-1"))):
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        data = torch.randn((CH_DAYS, side, side), generator=gen,
                           device=device)
        data.mul_(sd).add_(mu)
        if name == "pr":
            data.abs_()
        out[name] = ClimArray(data, ("time", "lat", "lon"), coords,
                              {"units": units}, name)
    return out


def _chain_steps(arrays):
    """bench.py's make_step for each registry step (bench.py:580-587):
    each takes the four inputs' tensors."""
    import xclim_tpu_torch.indicators  # noqa: F401  (fills the registry)
    from xclim_tpu_torch.core.indicator import registry

    def make_step(key, var, kw):
        def step(*data):
            d = {}
            for name, x in zip(CH_VARS, data):
                a = arrays[name].copy(data=x)
                a.attrs = dict(arrays[name].attrs)
                a.name = name
                d[name] = a
            return registry[key](d[var], **kw)
        return step

    return [make_step(*s) for s in CH_STEPS]


def _runs_per_year(cond, years):
    """Per year and cell: the days in runs of at least 5 days and the
    longest run of a (time, cells) bool condition, by a plain loop over
    the 365 days of every year at once (runs end at the year's end)."""
    import torch

    c = cond.reshape(years, 365, -1)
    run = torch.zeros(c.shape[0], c.shape[2], dtype=torch.int32,
                      device=c.device)
    longest = torch.zeros_like(run)
    in_waves = torch.zeros_like(run)
    for d in range(365):
        run = torch.where(c[:, d], run + 1, 0)
        longest = torch.maximum(longest, run)
        ends = (~c[:, d + 1]) if d + 1 < 365 else torch.ones_like(c[:, d])
        in_waves += torch.where(ends & (run >= 5), run, 0)
    return in_waves, longest


def _chain_plain(arrays):
    """Each step's values by plain expressions on the card, independent of
    the package (noleap years of 365 days, months of fixed lengths), sums
    in float64: monthly means, the day counts, the degree-day sums, the
    days in runs of at least 5 days above 25 degC, the longest run below 1
    mm/day, the annual totals in mm."""
    import numpy as np
    import torch

    years = CH_DAYS // 365
    tas = arrays["tas"].data.reshape(CH_DAYS, -1)
    tx = arrays["tasmax"].data.reshape(CH_DAYS, -1)
    tn = arrays["tasmin"].data.reshape(CH_DAYS, -1)
    pr = arrays["pr"].data.reshape(CH_DAYS, -1)
    lengths = np.tile([31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31],
                      years)
    starts = np.concatenate([[0], np.cumsum(lengths)[:-1]])
    tg = torch.stack([tas[s:s + n].double().mean(0)
                      for s, n in zip(starts, lengths)])

    def per_year(x):
        return x.reshape(years, 365, -1).sum(1)

    waves, _ = _runs_per_year(tx > 298.15, years)
    _, dry = _runs_per_year(pr < 1.0 / 86400.0, years)
    # each day's term in float32 (as an index computes it), summed in
    # float64
    return {"TG_MEAN": tg,
            "TX_DAYS_ABOVE": per_year((tx > 298.15).int()),
            "FROST_DAYS": per_year((tn < 273.15).int()),
            "ICE_DAYS": per_year((tx < 273.15).int()),
            "GROWING_DEGREE_DAYS": per_year(
                (tas - 277.15).clamp(min=0).double()),
            "HEATING_DEGREE_DAYS": per_year(
                (290.15 - tas).clamp(min=0).double()),
            "COOLING_DEGREE_DAYS": per_year(
                (tas - 291.15).clamp(min=0).double()),
            "HEAT_WAVE_INDEX": waves,
            "CDD": dry,
            "PRCPTOT": per_year((pr * 86400.0).double())}


#: the float steps' bound against their float64 expressions: the port
#: rounds each day's term to float32 and the float64 sum once
CH_FLOAT = {"TG_MEAN", "GROWING_DEGREE_DAYS", "HEATING_DEGREE_DAYS",
            "COOLING_DEGREE_DAYS", "PRCPTOT"}


def phase_chain(device, card, record):
    """bench.py's fused 10-indicator chain (the CLI --fused path) at its
    two rows, 320 x 320 and 100 x 100 cells x 10 noleap years: each step's
    launches and twin calls, the whole chain's, values against plain
    per-year expressions, peak memory, and segred and spells against their
    twins at the chain's own inputs. The chain's time is the benchmark's
    ``icclim16k.chain`` cell (30 icclim indicators, 16384 cells x 30
    years)."""
    import torch

    from perfbench import roofline
    from xclim_tpu_torch import climjit_chain
    from xclim_tpu_torch.ops import segred, spells

    crop = None
    for side in CH_SIDES:
        arrays = _chain_inputs(device, side)
        datas = [arrays[k].data for k in CH_VARS]
        nbytes = sum(d.numel() * 4 for d in datas)
        steps = _chain_steps(arrays)
        fused = climjit_chain(steps)
        if fused.partition != [(0, len(CH_STEPS))]:
            raise AssertionError(f"chain partition {fused.partition}")
        plain = _chain_plain(arrays)
        errs = {}
        # each step once: counts from zero, read right after
        for (key, var, kw), step in zip(CH_STEPS, steps):
            _reset_counts()
            out = step(*datas)
            torch.cuda.synchronize()
            counts = _counts()
            want = dict({k: 0 for k in counts}, **CH_LAUNCHES[key])
            if counts != want:
                raise AssertionError(f"{key} at {side}^2: launch counts "
                                     f"{counts}, expected {want}")
            exp = plain[key]
            if (tuple(out.shape) != (exp.shape[0], side, side)
                    or out.data.dtype != torch.float32
                    or out.data.device != device):
                raise AssertionError(f"{key}: {tuple(out.shape)} "
                                     f"{out.data.dtype} on {out.data.device}")
            got = out.data.reshape(exp.shape)
            if key in CH_FLOAT:
                errs[key] = _compare(f"{key} at {side}^2 vs its per-year "
                                     f"expression", got, exp, atol=0.0)
            elif not torch.equal(got, exp.to(torch.float32)):
                raise AssertionError(f"{key} at {side}^2 differs from its "
                                     f"per-year expression")
            else:
                errs[key] = 0.0
            _log(f"[chain] {key} at {side}^2: launches "
                 f"{json.dumps({k: v for k, v in counts.items() if v})}, "
                 f"twin calls 0; mean {float(out.data.double().mean()):.6g} "
                 f"{out.attrs.get('units')!r}, agrees with its per-year "
                 f"expression (max_abs_err {errs[key]:.3g})")
            del out
        del plain
        # the whole chain: counts from zero, read right after
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        _reset_counts()
        outs = fused(*datas)
        torch.cuda.synchronize()
        counts = _counts()
        peak = (torch.cuda.max_memory_allocated() - base) / 2**30
        want = {k: 0 for k in counts}
        for key, _, _ in CH_STEPS:
            for k, v in CH_LAUNCHES[key].items():
                want[k] += v
        if counts != want or len(outs) != len(CH_STEPS):
            raise AssertionError(f"chain at {side}^2: launch counts {counts}"
                                 f", expected {want}")
        name = f"fused chain {side}x{side}"
        for k in ("segred", "spells"):
            record[k]["paths"][name] = counts[k]
        del outs
        _log(f"[chain] fused 10-indicator chain ({CH_DAYS}, {side}, {side}) "
             f"on {card}: peak device memory above the inputs "
             f"{peak:.3f} GiB (inputs {nbytes / 2**30:.3f} GiB); launches "
             f"{json.dumps({k: v for k, v in counts.items() if v})}, twin "
             f"calls 0; partition {fused.partition}")
        if side != CH_SIDES[0]:
            continue

        # segred and spells against their twins at the chain's own inputs
        ys = arrays["tas"].resample("YS").spec
        ms_spec = arrays["tas"].resample("MS").spec
        x2 = arrays["tas"].data.reshape(CH_DAYS, -1)
        p2 = arrays["pr"].data.reshape(CH_DAYS, -1)
        cases = {
            "segred mean MS (TG_MEAN's tas)": (
                segred.segment_reduce_onepass, segred.segment_reduce_onepass_plain,
                (x2, ms_spec.starts, ms_spec.counts, "mean")),
            "segred sum YS (PRCPTOT's pr)": (
                segred.segment_reduce_onepass, segred.segment_reduce_onepass_plain,
                (p2, ys.starts, ys.counts, "sum")),
        }
        for label, (kern, twin, args) in cases.items():
            err = _compare(f"{label} kernel vs twin", kern(*args),
                           twin(*args), atol=0.0)
            record["segred"]["max_abs_err"] = max(
                record["segred"]["max_abs_err"], err)
            ms = _cuda_ms(lambda: kern(*args), 10)
            pms = _cuda_ms(lambda: twin(*args), 2)
            b = roofline.bound(args[0].numel() * 4
                       + len(args[1]) * args[0].shape[1] * 8,
                       args[0].numel())
            _log(f"[kernel vs twin] {label} {tuple(args[0].shape)} on "
                 f"{card}: max_abs_err={err} kernel_ms={ms:.4f} "
                 f"twin_ms={pms:.4f} bound_ms={b['bound_ms']:.4f} "
                 f"({b['bound_by']})")
        dry = (p2 < 1.0 / 86400.0)
        hot = (arrays["tasmax"].data.reshape(CH_DAYS, -1) > 298.15)
        for label, cond, window in (("CDD's pr < 1 mm/day", dry, 1),
                                    ("HEAT_WAVE_INDEX's tasmax > 25 degC",
                                     hot, 5)):
            got = spells.spell_stats(cond, ys.starts, ys.counts, window)
            ref = spells.spell_stats_plain(cond, ys.starts, ys.counts, window)
            err = max(_compare(f"spells {label} {k}", g, r, rtol=0.0,
                               atol=0.0)
                      for k, g, r in zip(("cnt", "wrc", "wre", "lng"), got,
                                         ref))
            del got, ref
            record["spells"]["max_abs_err"] = max(
                record["spells"]["max_abs_err"], err)
            ms = _cuda_ms(lambda: spells.spell_stats(
                cond, ys.starts, ys.counts, window), 10)
            pms = _cuda_ms(lambda: spells.spell_stats_plain(
                cond, ys.starts, ys.counts, window), 2)
            b = roofline.bound(cond.numel() + 4 * ys.nseg * cond.shape[1] * 4,
                       cond.numel())
            _log(f"[kernel vs twin] spells at {label} {tuple(cond.shape)} YS "
                 f"window {window} on {card}: max_abs_err={err} "
                 f"kernel_ms={ms:.4f} twin_ms={pms:.4f} "
                 f"bound_ms={b['bound_ms']:.4f} ({b['bound_by']})")
        del dry, hot, x2, p2
        crop = {k: a.copy(data=a.data[:, :CH_CROP, :CH_CROP].contiguous())
                for k, a in arrays.items()}
        for k, a in crop.items():
            a.coords = dict(a.coords, lat=a.coords["lat"][:CH_CROP],
                            lon=a.coords["lon"][:CH_CROP])
        del arrays, datas, fused, steps
        torch.cuda.empty_cache()
    return crop


def phase_chain_cpu_vs_card(crop):
    """The chain on a 32 x 32 crop: CPU tensors (the twins) against the
    card (the kernels); counts and run lengths value-equal, sums within
    RTOL, attrs equal but for the history line's timestamp."""
    import torch

    from xclim_tpu_torch import climjit_chain

    cpu = {k: a.to("cpu") for k, a in crop.items()}
    before = _counts()
    out_c = climjit_chain(_chain_steps(cpu))(*[cpu[k].data for k in CH_VARS])
    mid = _counts()
    out_g = climjit_chain(_chain_steps(crop))(
        *[crop[k].data for k in CH_VARS])
    torch.cuda.synchronize()
    after = _counts()
    on_cpu = {k: mid[k] - before[k] for k in after}
    on_card = {k: after[k] - mid[k] for k in after}
    if (on_cpu["spells"] or on_cpu["segred"] or on_card["spells_twin"]
            or on_card["segred_twin"] or not on_cpu["segred_twin"]
            or not on_card["spells"]):
        raise AssertionError(f"the CPU run must use the twins, the card the "
                             f"kernels: {on_cpu} then {on_card}")
    errs = {}
    for (key, _, _), g, c in zip(CH_STEPS, out_g, out_c):
        errs[key] = _compare(f"{key} cpu vs card", g.data, c.data,
                             rtol=RTOL if key in CH_FLOAT else 0.0, atol=0.0)
        ga = {k: v for k, v in g.attrs.items() if k != "history"}
        ca = {k: v for k, v in c.attrs.items() if k != "history"}
        if ga != ca or g.dims != c.dims:
            raise AssertionError(f"{key}: attrs differ: {ga} vs {ca}")
    _log(f"[cpu twins vs card kernels] fused chain on {CH_CROP}x{CH_CROP} "
         f"cells x {CH_DAYS} days: max_abs_err {json.dumps(errs)} (counts "
         f"and runs value-equal, sums within rtol {RTOL}); twins on the CPU "
         f"{json.dumps({k: v for k, v in on_cpu.items() if v})}, kernels on "
         f"the card {json.dumps({k: v for k, v in on_card.items() if v})}")


BR_SIDE = 128         # 128 x 128 cells: the breadth phase's grid
BR_YEARS = 30
BR_CROP = 8           # side of the crop held against the CPU runs
BR_HOURLY_CELLS = 16384
BR_HOURLY_CROP = 256  # cells of the hourly crop held against the CPU run
BR_HOURS = 8760       # one noleap year of hours
BR_JET_LATS = 64
#: call -> (rtol, atol) for the card against the CPU run on the crop:
#: float32 exp, log, pow and tanh round an ulp another way on the card, so
#: the physics holds to 1e-5 relative (an exponent of ~20 that cancels:
#: tests/test_torch_converters.py); day counts, zones, doys and the
#: threshold phase split are exact, sums 1e-6; the standardized indices
#: to stats.standardized_index's bounds (tests/test_torch_stats.py: the
#: closed-form fits cancel to ~4e-4 of a parameter, igamma and ndtri differ
#: by ulps: 1e-3)
BR_TOL = {"exact": (0.0, 0.0), "sum": (RTOL, 0.0), "phys": (1e-5, 1e-6),
          "pet": (1e-5, 3e-10), "ratio": (0.0, 1e-6), "si": (0.0, 1e-3)}
#: the classes whose values may pass their bound in a small share: a
#: standardized index (a fit whose closed form cancels): (share, largest
#: difference). The chill portions are held to a float64 replay instead
#: (_chill_check).
FLIP = {"si": (0.01, 0.05)}


def _breadth_inputs(device):
    """Daily inputs at 128 x 128 cells x 30 noleap years with a lat
    coordinate (-60..60): pr with 45-55 % dry days (exponential wet days of
    mean 4 mm/d), tas/tasmin/tasmax with a seasonal cycle, hurs, sfcWind
    and the four radiation terms, each (10950, 128, 128) float32 made on
    the card from one seeded generator."""
    import math

    import numpy as np
    import torch

    from xclim_tpu_torch.core.calendar import date_range
    from xclim_tpu_torch.core.dataarray import ClimArray

    t = date_range("1981-01-01", periods=BR_YEARS * 365, freq="D",
                   calendar="noleap")
    lat = np.linspace(-60.0, 60.0, BR_SIDE)
    coords = {"time": t, "lat": lat, "lon": np.arange(float(BR_SIDE))}
    shape = (len(t), BR_SIDE, BR_SIDE)
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 9)
    doy = torch.arange(len(t), device=device) % 365
    season = torch.cos(2 * math.pi * (doy - 200) / 365.0).reshape(-1, 1, 1)
    north = torch.as_tensor(np.sign(lat), dtype=torch.float32,
                            device=device).reshape(1, -1, 1)

    def normal(mu, sd, seas=0.0):
        x = torch.randn(shape, generator=gen, device=device).mul_(sd)
        return x.add_(mu + seas * season * north)

    dry = 0.45 + 0.1 * torch.rand((1, BR_SIDE, BR_SIDE), generator=gen,
                                  device=device)
    u = torch.rand(shape, generator=gen, device=device)
    w = torch.rand(shape, generator=gen, device=device)
    pr = torch.where(u < dry, 0.0, -4.0 / 86400.0 * torch.log1p(-w))
    del u, w
    tas = normal(283.0, 3.0, 10.0)
    spec = {
        "pr": (pr, "kg m-2 s-1", "precipitation_flux", None),
        "tas": (tas, "K", "air_temperature", "time: mean"),
        "tasmin": (tas - 6.0 + normal(0.0, 1.0), "K", "air_temperature",
                   "time: minimum"),
        "tasmax": (tas + 6.0 + normal(0.0, 1.0), "K", "air_temperature",
                   "time: maximum"),
        "hurs": (normal(70.0, 12.0).clamp_(5.0, 100.0), "%",
                 "relative_humidity", None),
        "sfcWind": (normal(4.0, 2.0).abs_(), "m s-1", "wind_speed", None),
        "rsds": (normal(180.0, 60.0, 80.0).clamp_(min=0.0), "W m-2",
                 "surface_downwelling_shortwave_flux_in_air", None),
        "rsus": (normal(35.0, 8.0).clamp_(min=0.0), "W m-2",
                 "surface_upwelling_shortwave_flux_in_air", None),
        "rlds": (normal(300.0, 25.0), "W m-2",
                 "surface_downwelling_longwave_flux_in_air", None),
        "rlus": (normal(380.0, 25.0), "W m-2",
                 "surface_upwelling_longwave_flux_in_air", None),
    }
    out = {}
    for name, (data, units, sn, cm) in spec.items():
        attrs = {"units": units, "standard_name": sn}
        if cm:
            attrs["cell_methods"] = cm
        out[name] = ClimArray(data, ("time", "lat", "lon"), coords, attrs,
                              name)
    return out


def _breadth_calls(a):
    """name -> (tolerance class, call) of each new index module's public
    functions on the inputs `a`."""
    from xclim_tpu_torch import indices
    from xclim_tpu_torch.indicators import atmos

    pet = indices.potential_evapotranspiration(
        tasmin=a["tasmin"], tasmax=a["tasmax"], method="HG85")
    wb = indices.water_budget(a["pr"], evspsblpot=pet)
    # gamma's and fisk's fits are one closed form for ML and APP alike
    # (indices/stats.py _fit_gamma, _fit_fisk): each pair does the same work
    calls = {
        "spi-3 gamma ML (APP's closed form)": ("si", lambda: indices.standardized_precipitation_index(
            a["pr"], freq="MS", window=3, dist="gamma", method="ML")),
        "spi-3 gamma APP": ("si", lambda: indices.standardized_precipitation_index(
            a["pr"], freq="MS", window=3, dist="gamma", method="APP")),
        "spei-3 fisk ML (PWM, as APP)": ("si", lambda:
                           indices.standardized_precipitation_evapotranspiration_index(
                               wb, freq="MS", window=3, dist="fisk", method="ML")),
        "spei-3 fisk APP (PWM)": ("si", lambda:
                            indices.standardized_precipitation_evapotranspiration_index(
                                wb, freq="MS", window=3, dist="fisk", method="APP")),
        # the default 20-day dry end is almost never met at ~50 % dry days
        "rain_season": ("exact", lambda: indices.rain_season(
            a["pr"], thresh_dry_end="1 mm", window_dry_end=5)),
        "dryness_index": ("sum", lambda: indices.dryness_index(a["pr"], pet)),
        "tg_mean_warmcold_quarter": ("sum", lambda:
                                     indices.tg_mean_warmcold_quarter(a["tas"])),
        "tg_mean_wetdry_quarter": ("sum", lambda:
                                   indices.tg_mean_wetdry_quarter(a["tas"], a["pr"])),
        "prcptot_wetdry_quarter": ("sum", lambda:
                                   indices.prcptot_wetdry_quarter(a["pr"])),
        "prcptot_warmcold_quarter": ("sum", lambda: indices.prcptot_warmcold_quarter(
            a["pr"], a["tas"], op="coldest")),
        "aridity_index": ("sum", lambda: indices.aridity_index(a["pr"], pet)),
        "antecedent_precipitation_index": ("sum", lambda:
                                           indices.antecedent_precipitation_index(a["pr"])),
        "utci (mrt from the radiation terms)": ("phys", lambda:
            indices.universal_thermal_climate_index(
                a["tas"], a["hurs"], a["sfcWind"], rsds=a["rsds"],
                rsus=a["rsus"], rlds=a["rlds"], rlus=a["rlus"])),
        "liquid_precip_ratio without prsn": ("ratio", lambda:
                                             indices.liquid_precip_ratio(
                                                 a["pr"], tas=a["tas"])),
        "precip_accumulation liquid": ("sum", lambda: indices.precip_accumulation(
            a["pr"], tas=a["tas"], phase="liquid")),
        "precip_average solid": ("sum", lambda: indices.precip_average(
            a["pr"], tas=a["tas"], phase="solid")),
        "atmos.huglin_index": ("sum", lambda: atmos.huglin_index(a["tas"],
                                                                 a["tasmax"])),
        "atmos.biologically_effective_degree_days": ("sum", lambda:
            atmos.biologically_effective_degree_days(a["tasmin"], a["tasmax"])),
        "atmos.latitude_temperature_index": ("sum", lambda:
            atmos.latitude_temperature_index(a["tas"])),
        "atmos.usda_hardiness_zones": ("exact", lambda:
                                       atmos.usda_hardiness_zones(a["tasmin"])),
        "atmos.australian_hardiness_zones": ("exact", lambda:
            atmos.australian_hardiness_zones(a["tasmin"])),
        "atmos.cool_night_index": ("sum", lambda:
                                   atmos.cool_night_index(a["tasmin"])),
        "atmos.corn_heat_units": ("sum", lambda: atmos.corn_heat_units(
            a["tasmin"], a["tasmax"])),
        "atmos.effective_growing_degree_days": ("sum", lambda:
            atmos.effective_growing_degree_days(a["tasmax"], a["tasmin"])),
    }
    for method in ("BR65", "HG85", "DA02", "MB05", "TW48", "FAO_PM98"):
        calls[f"pet {method}"] = ("pet", lambda m=method:
                                  indices.potential_evapotranspiration(
                                      tasmin=a["tasmin"], tasmax=a["tasmax"],
                                      tas=a["tas"], hurs=a["hurs"],
                                      rsds=a["rsds"], rsus=a["rsus"],
                                      rlds=a["rlds"], rlus=a["rlus"],
                                      sfcWind=a["sfcWind"], pr=a["pr"],
                                      method=m))
    return calls


def _hourly_inputs(device, cells, hours):
    """One noleap year of hourly tas (a diurnal and a seasonal cycle around
    5 degC) and pr (70 % dry hours) at `cells` cells."""
    import math

    import numpy as np
    import torch

    from xclim_tpu_torch.core.calendar import date_range
    from xclim_tpu_torch.core.dataarray import ClimArray

    t = date_range("2000-07-01", periods=hours, freq="h", calendar="noleap")
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 10)
    h = torch.arange(hours, device=device, dtype=torch.float32)
    cyc = (278.15 + 8.0 * torch.cos(2 * math.pi * h / 8760.0)
           + 4.0 * torch.sin(2 * math.pi * h / 24.0)).reshape(-1, 1)
    tas = cyc + 2.0 * torch.randn((hours, cells), generator=gen,
                                  device=device)
    u = torch.rand((hours, cells), generator=gen, device=device)
    pr = torch.where(u < 0.7, 0.0,
                     2e-4 * torch.rand((hours, cells), generator=gen,
                                       device=device))
    coords = {"time": t, "cell": np.arange(cells)}
    return (ClimArray(tas, ("time", "cell"), coords,
                      {"units": "K", "standard_name": "air_temperature"},
                      "tas"),
            ClimArray(pr, ("time", "cell"), coords,
                      {"units": "kg m-2 s-1",
                       "standard_name": "precipitation_flux"}, "pr"))


def _chill_check(tas_h, tas_c, got, want, card):
    """atmos.cp's chill portions on the hourly crop, on the card and on the
    CPU, each held to a float64 replay that follows its own banking
    decisions (xclim_tpu_torch.testing.check_chill_portions: a decision
    that differs from float64's only within 1e-5 of E = 1, period sums
    within 1e-5 relative); the main path's crop equal to the crop's own
    run on the card; and, for each cell where the two devices' sums
    differ, E on both devices and in a float64 run of its own at their
    first differing decision."""
    import torch

    from xclim_tpu_torch.testing import check_chill_portions, chill_replay

    crop = tas_h.isel(cell=slice(0, BR_HOURLY_CROP))
    g, rg = check_chill_portions(crop)
    c, rc = check_chill_portions(tas_c)
    _compare("atmos.cp main path vs the crop's run on the card", got,
             g.data.cpu(), rtol=RTOL, atol=0.0)
    g, c = g.data.cpu(), c.data.cpu()
    for dev, r in (("card", rg), ("cpu", rc)):
        _log(f"[breadth] atmos.cp on the {dev}: {r['flips']} hourly "
             f"decisions differ from float64's own, all within "
             f"{r['flip_gap']:.3g} of E = 1; period sums within "
             f"{r['max_rel_err']:.3g} relative ({r['max_abs_err']:.3g} abs) "
             f"of the float64 replay under the {dev}'s decisions")
    far = ((g - c).abs() > 1e-6 + 1e-5 * c.abs()).nonzero().tolist()
    if far:
        E_free, xi, d_free = chill_replay(tas_c.data)
        spec = tas_c.segments("YS")
        for p, cell in far[:5]:
            lo = int(spec.starts[p])
            hi = lo + int(spec.counts[p])
            differ = (rg["bank"][lo:hi, cell]
                      != rc["bank"][lo:hi, cell]).nonzero()
            h = lo + int(differ[0]) if len(differ) else None
            at = ("no decision differs" if h is None else
                  f"first differing decision at hour {h}: E card "
                  f"{float(rg['E'][h, cell]):.9f}, cpu "
                  f"{float(rc['E'][h, cell]):.9f}, float64 "
                  f"{float(E_free[h, cell]):.9f}, xi {float(xi[h, cell]):.6g}")
            _log(f"[breadth] atmos.cp period {p} cell {cell}: card "
                 f"{float(g[p, cell]):.7f}, cpu {float(c[p, cell]):.7f}, "
                 f"float64 {float(d_free[lo:hi, cell].sum()):.7f} "
                 f"(float64 under the card's decisions "
                 f"{float(rg['replay'][p, cell]):.7f}, under the cpu's "
                 f"{float(rc['replay'][p, cell]):.7f}); {at}")
    _log(f"[breadth] atmos.cp card vs cpu on {card}: {len(far)} of "
         f"{c.numel()} period sums differ beyond rtol 1e-5, max "
         f"{float((g - c).abs().max()):.3g}")
    return [float((g - c).abs().max())]


def _breadth_check(name, tol, got, want):
    """Card outputs (cropped) against the CPU run's; every output has a
    finite value. A FLIP class: the same NaN pattern, under its share of
    the values beyond its bound and none beyond its largest difference."""
    import torch

    rtol, atol = BR_TOL[tol]
    errs = []
    for i, (g, c) in enumerate(zip(got, want)):
        g, c = g.float().cpu(), c.float().cpu()
        if not bool(torch.isfinite(g).any()):
            raise AssertionError(f"{name} [{i}]: no finite value")
        if tol not in FLIP:
            errs.append(_compare(f"{name} [{i}] cpu vs card", g, c,
                                 rtol=rtol, atol=atol))
            continue
        if not torch.equal(torch.isnan(g), torch.isnan(c)):
            raise AssertionError(f"{name} [{i}]: NaN patterns differ")
        ok = ~torch.isnan(c)
        e = (g - c).abs()[ok]
        share = float((e > atol + rtol * c[ok].abs()).double().mean())
        most, largest = FLIP[tol]
        if share >= most or float(e.max()) > largest:
            raise AssertionError(f"{name} [{i}] cpu vs card: {share:.4f} of "
                                 f"values beyond rtol {rtol} atol {atol}, "
                                 f"max {float(e.max())}")
        errs.append(float(e.max()))
    return errs


def phase_index_breadth(device, card, record):
    """Each new index module once at a size users run, against its CPU run
    on a crop: daily inputs at 128 x 128 cells x 30 noleap years (SPI-3 and
    SPEI-3, rain_season, dryness_index, the ANUCLIM quarters,
    aridity_index, antecedent_precipitation_index, every PET method, UTCI
    with MRT, the ten temperature indicators' daily members and the three
    converter branches of _multivariate); cp/cu and max_pr_intensity on
    one year of hourly data at 16384 cells (the chill scan's seconds and
    kernel launches); jetstream_metric_woollings on 30 years x 64
    latitudes."""
    import numpy as np
    import torch

    from xclim_tpu_torch import indices
    from xclim_tpu_torch.core.calendar import date_range
    from xclim_tpu_torch.core.dataarray import ClimArray
    from xclim_tpu_torch.indicators import atmos

    a = _breadth_inputs(device)
    each = a["pr"].data.numel() * 4
    _log(f"[breadth] inputs ({BR_YEARS * 365}, {BR_SIDE}, {BR_SIDE}) float32"
         f", {each / 1e9:.3f} GB each, {len(a)} variables")
    crop = {k: v.copy(data=v.data[:, :BR_CROP, :BR_CROP].contiguous())
            for k, v in a.items()}
    for v in crop.values():
        v.coords = dict(v.coords, lat=v.coords["lat"][:BR_CROP],
                        lon=v.coords["lon"][:BR_CROP])
    cpu = {k: v.to("cpu") for k, v in crop.items()}
    calls = _breadth_calls(a)
    calls_c = _breadth_calls(cpu)
    total = 0.0
    for name, (tol, fn) in calls.items():
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        first = time.perf_counter() - t0
        counts = {k: v for k, v in _counts().items() if v}
        if any(k.endswith("_twin") for k in counts):
            raise AssertionError(f"{name} on the card called a twin: {counts}")
        for k, v in counts.items():
            if k in record:
                record[k]["paths"][f"breadth {name}"] = v
        out = out if isinstance(out, tuple) else (out,)
        got = [o.data[..., :BR_CROP, :BR_CROP].cpu() for o in out]
        shapes = [tuple(o.shape) for o in out]
        del out
        sec, runs = _timed(fn)
        total += sec
        want = calls_c[name][1]()
        want = [w.data for w in (want if isinstance(want, tuple) else (want,))]
        errs = _breadth_check(name, tol, got, want)
        _log(f"[breadth] {name} {shapes} on {card}: {sec:.4f} s (median of 3 "
             f"after a warm-up; runs {[round(v, 4) for v in runs]}; first "
             f"call {first:.4f} s); "
             f"launches {json.dumps(counts)}; {BR_CROP}x{BR_CROP} crop: CPU "
             f"run max_abs_err {[float(f'{e:.3g}') for e in errs]} "
             f"({tol}: rtol {BR_TOL[tol][0]}, atol {BR_TOL[tol][1]})")
    _log(f"[breadth] the daily calls: {total:.3f} s in all (medians)")
    del a, calls, crop, cpu, calls_c
    torch.cuda.empty_cache()

    # hourly: the chill models and max_pr_intensity
    tas_h, pr_h = _hourly_inputs(device, BR_HOURLY_CELLS, BR_HOURS)
    tas_c, pr_c = (x.isel(cell=slice(0, BR_HOURLY_CROP)).to("cpu")
                   for x in (tas_h, pr_h))
    for name, tol, fn in (
            ("atmos.cp", "scan", lambda t, p: atmos.cp(t)),
            ("atmos.cu", "exact", lambda t, p: atmos.cu(t)),
            ("atmos.max_pr_intensity", "sum",
             lambda t, p: atmos.max_pr_intensity(p, window=3, freq="MS"))):
        out = fn(tas_h, pr_h)
        got = out.data[:, :BR_HOURLY_CROP].cpu()
        del out
        sec, runs = _timed(lambda: fn(tas_h, pr_h))
        launches, kms = _profile(f"[breadth] {name}",
                                 lambda: fn(tas_h, pr_h), card, top=3)
        want = fn(tas_c, pr_c)
        if tol == "scan":
            errs = _chill_check(tas_h, tas_c, got, want.data, card)
        else:
            errs = _breadth_check(name, tol, [got], [want.data])
        _log(f"[breadth] {name} ({BR_HOURS} h, {BR_HOURLY_CELLS} cells, "
             f"{tas_h.data.numel() * 4 / 1e9:.3f} GB) on {card}: {sec:.4f} s "
             f"(median of 3 after a warm-up; runs "
             f"{[round(v, 4) for v in runs]}), {launches} kernel launches, "
             f"{kms:.3f} ms of kernel time (torch.profiler); "
             f"{BR_HOURLY_CROP}-cell CPU run max_abs_err "
             f"{[float(f'{e:.3g}') for e in errs]}")
    del tas_h, pr_h
    torch.cuda.empty_cache()

    # the jet stream: 30 years x 64 latitudes
    n = BR_YEARS * 365
    lats = np.linspace(20.0, 80.0, BR_JET_LATS)
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 11)
    jet = torch.as_tensor(20 * np.exp(-((lats - 45) / 10) ** 2),
                          dtype=torch.float32, device=device)
    u = jet + torch.randn((n, BR_JET_LATS), generator=gen, device=device)
    u[500:503] = torch.nan
    t = date_range("1981-01-01", periods=n, freq="D", calendar="noleap")
    ua = ClimArray(u, ("time", "lat"), {"time": t, "lat": lats},
                   {"units": "m s-1"}, "ua")
    lat_out, strength = indices.jetstream_metric_woollings(ua)
    sec, runs = _timed(lambda: indices.jetstream_metric_woollings(ua))
    want = indices.jetstream_metric_woollings(ua.to("cpu"))
    errs = _breadth_check("jetstream_metric_woollings", "phys",
                          [lat_out.data.cpu(), strength.data.cpu()],
                          [w.data for w in want])
    mean_lat = float(torch.nanmean(lat_out.data))
    if abs(mean_lat - 45.0) > 3.0:
        raise AssertionError(f"jet latitude {mean_lat}, expected ~45")
    _log(f"[breadth] jetstream_metric_woollings ({n}, {BR_JET_LATS}) on "
         f"{card}: {sec:.4f} s (median of 3 after a warm-up; runs "
         f"{[round(v, 4) for v in runs]}); CPU run max_abs_err {errs}; mean "
         f"jet latitude {mean_lat:.2f} (planted at 45)")


FI_SIDE = 128         # 128 x 128 = 16384 cells
FI_YEARS = 30         # 10950 noleap days from 1981-01-01
FI_WARM_DAYS = 365    # the warm-up runs the same calls on the first year
FI_ROWS = [30, 110]   # two latitude rows (256 cells, -29 and 53 degrees)
#: two runs of the fire recurrences agree within 3e-6 of each output's
#: largest value (tests/test_torch_fire.py: XLA:CPU against torch; here
#: the card against the CPU), but where DMC's b jumps (33, 65)
FI_REC_TOL = 3e-6
#: the CFFWIS outputs that do not read DMC, held card against CPU; those
#: that do (DMC, BUI, FWI, DSR) are held on each device to its float64
#: replay (xclim_tpu_torch.testing.check_cffwis), since a b decision taken
#: on two sides of its jump by the two devices moves them for months
FI_HELD = ("dc", "ffmc", "isi")


def _fire_inputs(device):
    """tas with a seasonal cycle of each hemisphere's phase, pr with 45-55
    % dry days (exponential wet days of mean 5 mm/d), hurs, sfcWind and
    tasmax = tas + 6 K, each (10950, 128, 128) float32 made on the card,
    with a lat coordinate from -60 to 70 degrees."""
    import math

    import numpy as np
    import torch

    from xclim_tpu_torch.core.calendar import date_range
    from xclim_tpu_torch.core.dataarray import ClimArray

    t = date_range("1981-01-01", periods=FI_YEARS * 365, freq="D",
                   calendar="noleap")
    lat = np.linspace(-60.0, 70.0, FI_SIDE)
    coords = {"time": t, "lat": lat, "lon": np.arange(float(FI_SIDE))}
    shape = (len(t), FI_SIDE, FI_SIDE)
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 12)
    doy = torch.arange(len(t), device=device) % 365
    season = torch.cos(2 * math.pi * (doy - 200) / 365.0).reshape(-1, 1, 1)
    north = torch.as_tensor(np.sign(lat), dtype=torch.float32,
                            device=device).reshape(1, -1, 1)

    def normal(mu, sd):
        return torch.randn(shape, generator=gen, device=device).mul_(sd).add_(mu)

    dry = 0.45 + 0.1 * torch.rand((1, FI_SIDE, FI_SIDE), generator=gen,
                                  device=device)
    u = torch.rand(shape, generator=gen, device=device)
    w = torch.rand(shape, generator=gen, device=device)
    pr = torch.where(u < dry, 0.0, -5.0 / 86400.0 * torch.log1p(-w))
    del u, w
    tas = normal(0.0, 3.0).add_(283.0 + 12.0 * season * north)
    spec = {"tas": (tas, "K", "air_temperature", "time: mean"),
            "pr": (pr, "kg m-2 s-1", "precipitation_flux", None),
            "hurs": (normal(65.0, 15.0).clamp_(5.0, 100.0), "%",
                     "relative_humidity", None),
            "sfcWind": (normal(4.0, 2.5).abs_(), "m s-1", "wind_speed", None),
            "tasmax": (tas + 6.0, "K", "air_temperature", "time: maximum")}
    out = {}
    for name, (data, units, sn, cm) in spec.items():
        attrs = {"units": units, "standard_name": sn}
        if cm:
            attrs["cell_methods"] = cm
        out[name] = ClimArray(data, ("time", "lat", "lon"), coords, attrs,
                              name)
    return out


def _fire_calls(a):
    """name -> (kind, call on the inputs a): kind is the CFFWIS call's
    keyword arguments (a dict), "dc", "dmc", "chain" or "season"."""
    from xclim_tpu_torch.indicators import atmos

    def chain():
        kbdi = atmos.kbdi(a["pr"], a["tasmax"], "1000 mm/yr")
        df = atmos.df(a["pr"], kbdi)
        return kbdi, df, atmos.ffdi(df, a["tasmax"], a["hurs"], a["sfcWind"])

    calls = {}
    for name, kw in (("atmos.cffwis always on", {}),
                     ("atmos.cffwis WF93 overwintering",
                      {"season_method": "WF93", "overwintering": True}),
                     ("atmos.cffwis WF93 dry start",
                      {"season_method": "WF93", "dry_start": "CFS"})):
        calls[name] = (kw, lambda kw=kw: tuple(atmos.cffwis(
            tas=a["tas"], pr=a["pr"], sfcWind=a["sfcWind"], hurs=a["hurs"],
            **kw)))
    # the one-code runs, each after the CFFWIS call whose code it returns
    calls["atmos.dc WF93 overwintering"] = ("dc", lambda: (atmos.dc(
        tas=a["tas"], pr=a["pr"], season_method="WF93", overwintering=True),))
    calls["atmos.dmc always on"] = ("dmc", lambda: (atmos.dmc(
        tas=a["tas"], pr=a["pr"], hurs=a["hurs"]),))
    calls["kbdi -> df -> ffdi"] = ("chain", chain)
    calls["atmos.fire_season WF93"] = ("season", lambda: (atmos.fire_season(
        a["tas"], method="WF93"),))
    return calls


def _device_trace(fn):
    """One fn() under torch.profiler (CUDA activity only; the raw kernel
    events are read without building the profiler's tables, which a
    million launches would make slow): (wall ms profiled, kernel launches,
    summed kernel ms, idle share of the wall)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans = sorted((e.start_ns(), e.end_ns())
                   for e in prof.profiler.kineto_results.events()
                   if e.device_type() == DeviceType.CUDA)
    busy, end = 0, 0
    for s, e in spans:
        if e > end:
            busy += e - max(s, end)
            end = e
    kernel_ms = sum(e - s for s, e in spans) / 1e6
    return wall_ms, len(spans), kernel_ms, max(0.0, 1.0 - busy / 1e6 / wall_ms)


def _fire_check(name, kind, card, crop, earlier):
    """The card's outputs on the crop (CPU ClimArrays) against the CPU's
    run of the same call on the crop's inputs: CFFWIS each held to its
    float64 replay, and DC, FFMC and ISI to each other within FI_REC_TOL of
    their scale; atmos.dc and atmos.dmc equal to the code of the card's
    CFFWIS run with the same season (``earlier``, name -> crop outputs),
    DC to the CPU within FI_REC_TOL; KBDI to FI_REC_TOL, the drought factor
    and FFDI each on the card's own KBDI and DF to the physics bound; the
    fire season equal. Returns a line."""
    import torch

    from xclim_tpu_torch.indicators import atmos
    from xclim_tpu_torch.testing import check_cffwis

    def scale(x):
        return float(torch.nan_to_num(x.data.abs(), nan=0.0).max())

    def apart(g, c):
        return float(torch.nan_to_num((g.data.double() - c.data.double())
                                      .abs(), nan=0.0).max())

    if kind == "season":
        want = atmos.fire_season(crop["tas"], method="WF93")
        _compare(f"{name} cpu vs card", card[0].data, want.data, rtol=0.0,
                 atol=0.0)
        return f"equal to the CPU run ({int(want.data.sum())} season days)"
    if kind in ("dc", "dmc"):
        full, of = {"dc": ("atmos.cffwis WF93 overwintering", 0),
                    "dmc": ("atmos.cffwis always on", 1)}[kind]
        _compare(f"{name} vs the {kind} of {full} on the card", card[0].data,
                 earlier[full][of].data, rtol=0.0, atol=0.0)
        args = {k: crop[k] for k in ("tas", "pr", "hurs")}
        if kind == "dc":
            cpu = atmos.dc(tas=args["tas"], pr=args["pr"],
                           season_method="WF93", overwintering=True)
            e = _compare(f"{name} cpu vs card", card[0].data, cpu.data,
                         rtol=0.0, atol=FI_REC_TOL * scale(cpu))
            return (f"equal to the dc of {full} on the card; within {e:.3g} "
                    f"of the CPU run (bound {FI_REC_TOL * scale(cpu):.3g})")
        cpu = atmos.dmc(**args)
        return (f"equal to the dmc of {full} on the card (held to its "
                f"float64 replay); card vs cpu max {apart(card[0], cpu):.3g}")
    if kind == "chain":
        kbdi = atmos.kbdi(crop["pr"], crop["tasmax"], "1000 mm/yr")
        scale = float(kbdi.data.abs().max())
        e_k = _compare(f"{name} kbdi cpu vs card", card[0].data, kbdi.data,
                       rtol=0.0, atol=FI_REC_TOL * scale)
        df = atmos.df(crop["pr"], card[0])
        e_d = _compare(f"{name} df on the card's kbdi", card[1].data, df.data,
                       *BR_TOL["phys"])
        ffdi = atmos.ffdi(card[1], crop["tasmax"], crop["hurs"],
                          crop["sfcWind"])
        e_f = _compare(f"{name} ffdi on the card's df", card[2].data,
                       ffdi.data, *BR_TOL["phys"])
        return (f"kbdi within {e_k:.3g} of the CPU run (bound "
                f"{FI_REC_TOL * scale:.3g}); df {e_d:.3g}, ffdi {e_f:.3g} on "
                f"the card's own kbdi and df")
    args = {k: crop[k] for k in ("tas", "pr", "sfcWind", "hurs")}
    cpu = tuple(atmos.cffwis(**args, **kind))
    reports = [check_cffwis(o, **args, **kind) for o in (card, cpu)]
    held = {g.name: _compare(f"{name} {g.name} cpu vs card", g.data, c.data,
                             rtol=0.0, atol=FI_REC_TOL * scale(c))
            for g, c in zip(card, cpu) if g.name in FI_HELD}
    rest = {g.name: apart(g, c) for g, c in zip(card, cpu)
            if g.name not in FI_HELD}
    worst = {dev: max(r[o.name][0] for o in card) for dev, r in
             zip(("card", "cpu"), reports)}
    return (f"each device's days within {worst['card']:.3g} (card) and "
            f"{worst['cpu']:.3g} (cpu) of their float64 replays; card vs cpu "
            f"{', '.join(f'{k} {v:.3g}' for k, v in held.items())} (bound "
            f"{FI_REC_TOL} of the scale); the outputs that read DMC apart by "
            f"{', '.join(f'{k} {v:.3g}' for k, v in rest.items())}")


def phase_fire(device, card):
    """The fire-weather slice at 16384 cells x 30 noleap years: CFFWIS
    always on, with the WF93 season and overwintering, and with a dry
    start; atmos.dc (WF93, overwintering) and atmos.dmc (always on), which
    run their one code; the KBDI -> DF -> FFDI chain; the fire season.
    Each call after a
    warm-up on the first year: seconds (the median of 3, one timed call for
    the two season CFFWIS runs), peak device memory above the inputs, and
    a profiled run's kernel launches, kernel time and idle share; then the
    card's outputs on a 256-cell crop against the CPU's run."""
    import torch

    a = _fire_inputs(device)
    each = a["tas"].data.numel() * 4
    _log(f"[fire] inputs ({FI_YEARS * 365}, {FI_SIDE}, {FI_SIDE}) float32, "
         f"{each / 1e9:.3f} GB each: {', '.join(a)}")
    first = {k: v.isel(time=slice(0, FI_WARM_DAYS)) for k, v in a.items()}
    crop = {k: v.isel(lat=FI_ROWS).to("cpu") for k, v in a.items()}
    rows = torch.as_tensor(FI_ROWS, device=device)
    crops = {}
    for name, (kind, fn) in _fire_calls(a).items():
        _fire_calls(first)[name][1]()
        reps = 1 if isinstance(kind, dict) and kind else 3
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        runs, out = [], None
        for _ in range(reps):
            out = None
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            runs.append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated() - base
        counts = {k: v for k, v in _counts().items() if v}
        if counts:
            raise AssertionError(f"{name} launched a kernel or twin: {counts}")
        shapes = [tuple(o.shape) for o in out]
        got = tuple(o.copy(data=o.data.index_select(1, rows).cpu())
                    for o in out)
        for o in got:
            o.coords = dict(o.coords, lat=o.coords["lat"][FI_ROWS])
        del out
        wall, launches, kms, idle = _device_trace(fn)
        sec = statistics.median(runs)
        _log(f"[fire] {name} {shapes[0]} on {card}: {sec:.4f} s ("
             f"{'median of 3' if reps == 3 else 'one call'} after a warm-up "
             f"on {FI_WARM_DAYS} days; runs {[round(v, 4) for v in runs]}), "
             f"{FI_YEARS * 365 * FI_SIDE ** 2 / sec:,.1f} cell-days/s; peak "
             f"{peak / 2 ** 30:.3f} GiB above the inputs; profiled: wall "
             f"{wall:.1f} ms, {launches} kernel launches, {kms:.3f} ms of "
             f"kernel time, idle {idle * 100:.1f} %")
        _log(f"[fire] {name}: {len(FI_ROWS) * FI_SIDE}-cell crop: "
             f"{_fire_check(name, kind, got, crop, crops)}")
        crops[name] = got
    del a, first, crop
    torch.cuda.empty_cache()


LS_SIDE = 128         # the snow and generic grids: 128 x 128 cells
LS_YEARS = 30
LS_STATIONS = 4096    # streamflow stations
LS_ICE = (180, 360)   # a 1-degree sea-ice grid
LS_CROP = 8           # side (rows, stations) of the crops held against the CPU
LS_FIT_CROP = 32      # the ML fit's crop: its disagreements are counted
#: tolerance classes of the land, seaIce and generic calls beyond BR_TOL:
#: lag_snowpack_flow_peaks averages float32 seconds (4e-3 days,
#: tests/test_torch_hydro_anuclim.py); sen_slope takes differences of
#: annual means a few ulps apart (1e-4 m3/s a year); the GEV's PWM
#: estimator cancels in float32 (up to ~4e-4 of a parameter between two
#: orders of summing its weighted moments, tests/test_torch_stats.py) and
#: a 20-year return level extrapolates from it: 1e-4 relative (6.4e-6 on
#: the card against the CPU at 1024 cells of daily precipitation)
LS_TOL = {"lag": (0.0, 4e-3), "slope": (1e-5, 1e-4), "gev": (1e-4, 0.0)}


def _land_inputs(device):
    """At 128 x 128 cells x 30 noleap years: snd with a seasonal cover
    (cold-season depth and storms) and snw = 250 kg m-3 x snd, prsn, pr
    (45-55 % dry days) and sfcWind; at 4096 stations: streamflow q (a
    seasonal cycle and lognormal noise) with the stations' snw and pr;
    siconc on 180 x 360 cells with its cell area. Made on the card."""
    import math

    import numpy as np
    import torch

    from xclim_tpu_torch.core.calendar import date_range
    from xclim_tpu_torch.core.dataarray import ClimArray

    t = date_range("1981-01-01", periods=LS_YEARS * 365, freq="D",
                   calendar="noleap")
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 13)
    doy = torch.arange(len(t), device=device) % 365
    season = torch.cos(2 * math.pi * (doy - 20) / 365.0)

    def grid(shape, lats=(40.0, 80.0)):
        lat = np.linspace(*lats, shape[0])
        return ({"time": t, "lat": lat, "lon": np.arange(float(shape[1]))},
                season.reshape(-1, 1, 1), (len(t),) + shape, ("time", "lat", "lon"))

    def fields(coords, seas, shape, dims):
        depth = (0.35 * seas + 0.05 * torch.randn(shape, generator=gen,
                                                  device=device)).clamp_(min=0)
        storms = torch.rand(shape, generator=gen, device=device) < 0.03
        depth = torch.where(storms, depth + 0.3, depth)
        u = torch.rand(shape, generator=gen, device=device)
        w = torch.rand(shape, generator=gen, device=device)
        pr = torch.where(u < 0.5, 0.0, -4.0 / 86400.0 * torch.log1p(-w))
        spec = {"snd": (depth, "m", "surface_snow_thickness"),
                "snw": (depth * 250.0, "kg m-2", "surface_snow_amount"),
                "pr": (pr, "kg m-2 s-1", "precipitation_flux")}
        return {k: ClimArray(d, dims, coords, {"units": u, "standard_name": sn},
                             k) for k, (d, u, sn) in spec.items()}

    snow = fields(*grid((LS_SIDE, LS_SIDE)))
    coords, seas, shape, dims = grid((LS_SIDE, LS_SIDE))
    prsn = torch.where(torch.rand(shape, generator=gen, device=device) < 0.3,
                       1e-5 * torch.rand(shape, generator=gen, device=device),
                       0.0)
    wind = torch.randn(shape, generator=gen, device=device).mul_(3).add_(5).abs_()
    snow["prsn"] = ClimArray(prsn, dims, coords, {
        "units": "kg m-2 s-1", "standard_name": "snowfall_flux"}, "prsn")
    snow["sfcWind"] = ClimArray(wind, dims, coords, {
        "units": "m s-1", "standard_name": "wind_speed"}, "sfcWind")

    st_coords = {"time": t, "station": np.arange(float(LS_STATIONS))}
    st = (len(t), LS_STATIONS)
    st_seas = season.reshape(-1, 1)
    flow = fields(st_coords, st_seas, st, ("time", "station"))
    q = (50 + 25 * torch.roll(st_seas, 120, 0) + torch.exp(
        2 + torch.randn(st, generator=gen, device=device))).abs_()
    flow["q"] = ClimArray(q, ("time", "station"), st_coords, {
        "units": "m3 s-1",
        "standard_name": "water_volume_transport_in_river_channel"}, "q")

    coords, seas, shape, dims = grid(LS_ICE, (-89.5, 89.5))
    sic = (50 + 60 * seas + 20 * torch.randn(shape, generator=gen,
                                             device=device)).clamp_(0, 100)
    lat = torch.as_tensor(np.radians(coords["lat"]), dtype=torch.float32,
                          device=device)
    area = (1.2e10 * torch.cos(lat)).reshape(-1, 1).expand(LS_ICE).contiguous()
    ice = {"siconc": ClimArray(sic, dims, coords, {
               "units": "%", "standard_name": "sea_ice_area_fraction"},
               "siconc"),
           "areacello": ClimArray(area, ("lat", "lon"), {
               k: coords[k] for k in ("lat", "lon")},
               {"units": "m2", "standard_name": "cell_area"}, "areacello")}
    return snow, flow, ice


def _land_calls(snow, flow, ice):
    """name -> (tolerance class, call) of every land, seaIce and generic
    indicator on the inputs."""
    from xclim_tpu_torch.core.units import convert_units_to
    from xclim_tpu_torch.indicators import generic, land, seaIce

    s, f = snow, flow
    pr_mm = convert_units_to(s["pr"], "mm/d", context="hydro")
    return {
        "land.snd_season_length": ("exact", lambda: land.snd_season_length(s["snd"])),
        "land.snw_season_length": ("exact", lambda: land.snw_season_length(s["snw"])),
        "land.snd_season_start": ("exact", lambda: land.snd_season_start(s["snd"])),
        "land.snw_season_start": ("exact", lambda: land.snw_season_start(s["snw"])),
        "land.snd_season_end": ("exact", lambda: land.snd_season_end(s["snd"])),
        "land.snw_season_end": ("exact", lambda: land.snw_season_end(s["snw"])),
        "land.snd_storm_days": ("exact", lambda: land.snd_storm_days(
            s["snd"], thresh="20 cm")),
        "land.snw_storm_days": ("exact", lambda: land.snw_storm_days(
            s["snw"], thresh="40 kg m-2")),
        "land.snd_days_above": ("exact", lambda: land.snd_days_above(s["snd"])),
        "land.snw_days_above": ("exact", lambda: land.snw_days_above(s["snw"])),
        "land.blowing_snow": ("exact", lambda: land.blowing_snow(
            s["snd"], s["sfcWind"], snd_thresh="5 cm",
            sfcWind_thresh="15 km/h")),
        "land.snow_depth": ("sum", lambda: land.snow_depth(s["snd"])),
        "land.snd_max_doy": ("exact", lambda: land.snd_max_doy(s["snd"])),
        "land.snw_max": ("exact", lambda: land.snw_max(s["snw"])),
        "land.snw_max_doy": ("exact", lambda: land.snw_max_doy(s["snw"])),
        "land.snow_melt_we_max": ("sum", lambda: land.snow_melt_we_max(s["snw"])),
        "land.melt_and_precip_max": ("sum", lambda: land.melt_and_precip_max(
            s["snw"], s["pr"])),
        "land.holiday_snow_days": ("exact", lambda: land.holiday_snow_days(
            s["snd"])),
        "land.holiday_snow_and_snowfall_days": ("exact", lambda:
            land.holiday_snow_and_snowfall_days(s["snd"], s["prsn"])),
        "land.base_flow_index": ("sum", lambda: land.base_flow_index(f["q"])),
        "land.rb_flashiness_index": ("sum", lambda: land.rb_flashiness_index(
            f["q"])),
        "land.doy_qmax": ("exact", lambda: land.doy_qmax(f["q"])),
        "land.doy_qmin": ("exact", lambda: land.doy_qmin(f["q"])),
        "land.ssi": ("si", lambda: land.standardized_streamflow_index(
            f["q"], freq="MS")),
        "land.sgi (normal fit)": ("si", lambda:
            land.standardized_groundwater_index(f["snd"], freq="MS", window=2,
                                                dist="norm")),
        "land.flow_index": ("sum", lambda: land.flow_index(f["q"], p=0.95)),
        "land.high_flow_frequency": ("exact", lambda: land.high_flow_frequency(
            f["q"], threshold_factor=1.5)),
        "land.low_flow_frequency": ("exact", lambda: land.low_flow_frequency(
            f["q"], threshold_factor=0.8)),
        "land.base_flow_index_seasonal_ratio": ("sum", lambda:
            land.base_flow_index_seasonal_ratio(f["q"])),
        "land.lag_snowpack_flow_peaks": ("lag", lambda:
            land.lag_snowpack_flow_peaks(f["snw"], f["q"])),
        "land.runoff_ratio": ("sum", lambda: land.runoff_ratio(
            f["q"], f["pr"], area="1000 km2")),
        "land.sen_slope": ("slope", lambda: land.sen_slope(f["q"])),
        "seaIce.sea_ice_extent": ("sum", lambda: seaIce.sea_ice_extent(
            ice["siconc"], ice["areacello"])),
        "seaIce.sea_ice_area": ("sum", lambda: seaIce.sea_ice_area(
            ice["siconc"], ice["areacello"])),
        "generic.stats YS max": ("exact", lambda: generic.stats(
            pr_mm, freq="YS", op="max")),
        "generic.fit genextreme ML": ("fit", lambda: (
            generic.stats(pr_mm, freq="YS", op="max"),
            generic.fit(generic.stats(pr_mm, freq="YS", op="max"),
                        dist="genextreme"))),
        "generic.return_level (20 years, genextreme PWM)": ("gev", lambda:
            generic.return_level(pr_mm)),
    }


def _land_crop(da):
    """The first LS_CROP rows and columns (LS_CROP^2 stations) of da, on the
    CPU; the sea-ice sums run over the whole grid, so their inputs and
    outputs are cut to the first year instead."""
    dims = da.dims
    if dims == ("time",) or ("lat" in dims and da.shape[dims.index("lat")]
                             == LS_ICE[0]):
        return (da.isel(time=slice(0, 365)) if "time" in dims else da).to(
            "cpu")
    cut = {d: slice(0, LS_CROP) for d in ("lat", "lon") if d in dims}
    if "station" in dims:
        cut["station"] = slice(0, LS_CROP ** 2)
    return da.isel(**cut).to("cpu")


def phase_land_seaice_generic(device, card, record):
    """Each land (snow, streamflow), seaIce and generic indicator once at a
    size users run: the snow indicators and the generic ones at 128 x 128
    cells x 30 years, streamflow at 4096 stations, sea-ice extent and area
    on 180 x 360 cells; each call's seconds and segred/spells launches (no
    twin on the card), and its outputs against its CPU run on a crop (the
    sea-ice sums on the whole grid over the first year, the GEV ML fit on
    32 x 32 cells)."""
    import torch

    from xclim_tpu_torch.core.units import convert_units_to

    snow, flow, ice = _land_inputs(device)
    _log(f"[land] inputs: {', '.join(snow)} ({LS_YEARS * 365}, {LS_SIDE}, "
         f"{LS_SIDE}); {', '.join(flow)} ({LS_YEARS * 365}, {LS_STATIONS}); "
         f"siconc ({LS_YEARS * 365}, {LS_ICE[0]}, {LS_ICE[1]}), "
         f"{ice['siconc'].data.numel() * 4 / 1e9:.3f} GB")
    cpu = ({k: _land_crop(v) for k, v in snow.items()},
           {k: _land_crop(v) for k, v in flow.items()},
           {k: _land_crop(v) for k, v in ice.items()})
    fit_cpu = convert_units_to(snow["pr"], "mm/d", context="hydro").isel(
        lat=slice(0, LS_FIT_CROP), lon=slice(0, LS_FIT_CROP)).to("cpu")
    calls_c = _land_calls(*cpu)
    total = 0.0
    for name, (tol, fn) in _land_calls(snow, flow, ice).items():
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        total += sec
        counts = {k: v for k, v in _counts().items() if v}
        if any(k.endswith("_twin") for k in counts):
            raise AssertionError(f"{name} on the card called a twin: {counts}")
        for k, v in counts.items():
            if k in record:
                record[k]["paths"][name] = v
        out = out if isinstance(out, tuple) else (out,)
        shapes = [tuple(o.shape) for o in out]
        if tol == "fit":
            got = [o.isel(lat=slice(0, LS_FIT_CROP), lon=slice(0, LS_FIT_CROP)
                          ).data.cpu() for o in out]
            errs = [_gev_fits_agree(name, got, fit_cpu)]
        else:
            got = [_land_crop(o).data for o in out]
            want = calls_c[name][1]()
            want = [w.data for w in (want if isinstance(want, tuple)
                                     else (want,))]
            if tol in LS_TOL:
                rtol, atol = LS_TOL[tol]
                errs = [_compare(f"{name} [{i}] cpu vs card", g, w,
                                 rtol=rtol, atol=atol)
                        for i, (g, w) in enumerate(zip(got, want))]
            else:
                errs = _breadth_check(name, tol, got, want)
        del out
        _log(f"[land] {name} {shapes} on {card}: {sec:.4f} s (one call); "
             f"launches {json.dumps(counts)}; crop: CPU run max_abs_err "
             f"{[float(f'{e:.3g}') for e in errs]} ({tol})")
    _log(f"[land] the {len(calls_c)} calls: {total:.3f} s in all")
    del snow, flow, ice, cpu, fit_cpu, calls_c
    torch.cuda.empty_cache()


CAL_YEARS = 60        # 1961-2020
CAL_CROP = 256        # cells of the crop held against the CPU


def _calendar_inputs(device):
    """tas at 16384 cells over 60 years: a noleap and a standard series,
    (21900 or 21915, 128, 128) float32 on the card."""
    import numpy as np
    import torch

    from xclim_tpu_torch.core.calendar import date_range
    from xclim_tpu_torch.core.dataarray import ClimArray

    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 14)
    out = {}
    for cal in ("noleap", "standard"):
        t = date_range("1961-01-01", end="2020-12-31", freq="D", calendar=cal)
        x = torch.randn((len(t), FI_SIDE, FI_SIDE), generator=gen,
                        device=device).mul_(8).add_(283)
        out[cal] = ClimArray(x, ("time", "lat", "lon"), {
            "time": t, "lat": np.linspace(-60.0, 70.0, FI_SIDE),
            "lon": np.arange(float(FI_SIDE))},
            {"units": "K", "standard_name": "air_temperature"}, "tas")
    return out


def _calendar_calls(a):
    """name -> call of each calendar array operation on the inputs."""
    from xclim_tpu_torch.core import calendar as cal

    nl, st = a["noleap"], a["standard"]
    return {
        "convert_calendar noleap -> 360_day": lambda: cal.convert_calendar(
            nl, "360_day"),
        "convert_calendar noleap -> 360_day -> noleap": lambda:
            cal.convert_calendar(cal.convert_calendar(nl, "360_day"), "noleap"),
        "convert_calendar standard -> noleap": lambda: cal.convert_calendar(
            st, "noleap"),
        "stack_periods(window=30, stride=10)": lambda: cal.stack_periods(
            nl, window=30, stride=10),
        "stack_periods + unstack_periods": lambda: cal.unstack_periods(
            cal.stack_periods(nl, window=30, stride=10)),
        "mask_between_doys (100, 250)": lambda: cal.mask_between_doys(
            st, (100, 250)),
        "select_time season JJA": lambda: cal.select_time(st, season="JJA"),
        "select_time month DJF, drop": lambda: cal.select_time(
            st, drop=True, month=[12, 1, 2]),
        "select_time doy_bounds (320, 60)": lambda: cal.select_time(
            nl, doy_bounds=(320, 60)),
    }


def phase_calendar(device, card):
    """The calendar's array operations at 16384 cells x 60 years (noleap
    and standard daily tas): calendar conversions, period stacking and its
    inverse, a doy mask and the time selections; each the median of 3
    after a warm-up, its outputs on a 256-cell crop equal to the CPU's run
    on the crop's inputs."""
    import torch

    a = _calendar_inputs(device)
    _log(f"[calendar] inputs: noleap {tuple(a['noleap'].shape)}, standard "
         f"{tuple(a['standard'].shape)} float32, "
         f"{a['standard'].data.numel() * 4 / 1e9:.3f} GB")
    rows = list(range(CAL_CROP // FI_SIDE))
    crop = {k: v.isel(lat=rows).to("cpu") for k, v in a.items()}
    calls_c = _calendar_calls(crop)
    for name, fn in _calendar_calls(a).items():
        _reset_counts()
        out = fn()
        torch.cuda.synchronize()
        counts = {k: v for k, v in _counts().items() if v}
        if counts:
            raise AssertionError(f"{name} launched a kernel or twin: {counts}")
        got = out.isel(lat=rows)
        want = calls_c[name]()
        if got.dims != want.dims:
            raise AssertionError(f"{name}: dims {got.dims} != {want.dims}")
        if "time" in want.coords and not bool(
                (got.time.encode() == want.time.encode()).all()):
            raise AssertionError(f"{name}: time coordinates differ")
        _compare(f"{name} cpu vs card", got.data, want.data, rtol=0.0,
                 atol=0.0)
        shape = tuple(out.shape)
        del out, got
        sec, runs = _timed(fn)
        _log(f"[calendar] {name} {shape} on {card}: {sec * 1e3:.3f} ms "
             f"(median of 3 after a warm-up; runs "
             f"{[round(v * 1e3, 3) for v in runs]} ms); {CAL_CROP}-cell crop "
             f"equal to the CPU run")
    del a, crop, calls_c
    torch.cuda.empty_cache()


YM_SIDE = 128         # 128 x 128 = 16384 cells
YM_YEARS = 30         # 10950 noleap days from 1981-01-01
YM_CROP = 8           # side of the crop held against the CPU run
YM_MODULES = ("icclim", "anuclim", "cf")
#: the units of pr each module reads (anuclim's totals convert their
#: output to "mm", which needs an amount rate)
YM_PR_UNITS = {"icclim": "kg m-2 s-1", "anuclim": "mm d-1",
               "cf": "kg m-2 s-1"}
#: percentile input -> (variable, percentile)
YM_PERCENTILES = {"tas_per": ("tas", 90), "tasmax_per": ("tasmax", 90),
                  "tasmin_per": ("tasmin", 10), "pr_per": ("pr", 75)}


def _yaml_inputs(device):
    """Every variable the three YAML modules read, (10950, 128, 128)
    float32 on the card from one seeded generator (0.72 GB each): tas,
    tasmax, tasmin with each hemisphere's seasonal cycle, pr with 45-55 %
    dry days, snd with winter snow, hurs, psl, sfcWind, wsgsmax, sund; a
    lat coordinate from -60 to 70."""
    import math

    import numpy as np
    import torch

    from xclim_tpu_torch.core.calendar import date_range
    from xclim_tpu_torch.core.dataarray import ClimArray

    t = date_range("1981-01-01", periods=YM_YEARS * 365, freq="D",
                   calendar="noleap")
    lat = np.linspace(-60.0, 70.0, YM_SIDE)
    coords = {"time": t, "lat": lat, "lon": np.arange(float(YM_SIDE))}
    shape = (len(t), YM_SIDE, YM_SIDE)
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 15)
    doy = torch.arange(len(t), device=device) % 365
    season = torch.cos(2 * math.pi * (doy - 200) / 365.0).reshape(-1, 1, 1)
    north = torch.as_tensor(np.sign(lat), dtype=torch.float32,
                            device=device).reshape(1, -1, 1)

    def normal(mu, sd, seas=0.0):
        x = torch.randn(shape, generator=gen, device=device).mul_(sd)
        return x.add_(mu + seas * season * north)

    dry = 0.45 + 0.1 * torch.rand((1, YM_SIDE, YM_SIDE), generator=gen,
                                  device=device)
    u = torch.rand(shape, generator=gen, device=device)
    w = torch.rand(shape, generator=gen, device=device)
    pr = torch.where(u < dry, 0.0, -6.0 / 86400.0 * torch.log1p(-w))
    del u, w
    tas = normal(281.0, 3.0, 12.0)
    spec = {
        "tas": (tas, "K", "air_temperature", "time: mean"),
        "tasmax": (tas + 6.0 + normal(0.0, 1.0), "K", "air_temperature",
                   "time: maximum"),
        "tasmin": (tas - 6.0 + normal(0.0, 1.0), "K", "air_temperature",
                   "time: minimum"),
        "pr": (pr, "kg m-2 s-1", "precipitation_flux", None),
        "snd": (normal(0.05, 0.2, -0.3).clamp_(min=0.0), "m",
                "surface_snow_thickness", None),
        "hurs": (normal(70.0, 12.0).clamp_(5.0, 100.0), "%",
                 "relative_humidity", None),
        "psl": (normal(101300.0, 900.0), "Pa", "air_pressure_at_sea_level",
                None),
        "sfcWind": (normal(5.0, 3.0).abs_(), "m s-1", "wind_speed", None),
        "wsgsmax": (normal(14.0, 5.0).abs_(), "m s-1", "wind_speed_of_gust",
                    None),
        "sund": (normal(20000.0, 12000.0, 8000.0).clamp_(min=0.0), "s",
                 "duration_of_sunshine", None),
    }
    out = {}
    for name, (data, units, sn, cm) in spec.items():
        attrs = {"units": units, "standard_name": sn}
        if cm:
            attrs["cell_methods"] = cm
        out[name] = ClimArray(data, ("time", "lat", "lon"), coords, attrs,
                              name)
    return out


def _yaml_datasets(a):
    """Per module, the ClimDataset its indicators read: the inputs, pr in
    the module's units and the four percentile inputs (percentile_doy,
    window 5, over the series itself)."""
    from xclim_tpu_torch.core.dataarray import ClimDataset
    from xclim_tpu_torch.core.percentiles import percentile_doy
    from xclim_tpu_torch.core.units import convert_units_to

    base = ClimDataset(dict(a))
    for key, (var, per) in YM_PERCENTILES.items():
        base[key] = percentile_doy(a[var], window=5, per=per)
    out = {}
    for m in YM_MODULES:
        ds = base.copy()
        if YM_PR_UNITS[m] != a["pr"].attrs["units"]:
            ds["pr"] = convert_units_to(a["pr"], YM_PR_UNITS[m],
                                        context="hydro")
        out[m] = ds
    return out


def _ym_crop(ds):
    """The first YM_CROP x YM_CROP cells of every variable, on the CPU."""
    from xclim_tpu_torch.core.dataarray import ClimDataset

    return ClimDataset({k: v.isel(lat=slice(0, YM_CROP),
                                  lon=slice(0, YM_CROP)).to("cpu")
                        for k, v in ds.items()})


def _ym_kwargs(ind):
    """freq="YS" where the indicator takes a freq its module does not set;
    a threshold of 10 degC where the module leaves it open (cf's *TT
    temperature spells and sums)."""
    import inspect

    out = {}
    for name, value in (("freq", "YS"), ("threshold", "10 degC")):
        p = ind.parameters.get(name)
        if p is not None and not p.injected and (
                name == "freq" or p.default is inspect.Parameter.empty):
            out[name] = value
    return out


def _ym_call(ind, ds):
    """(outputs as a tuple, None) or (None, the error) of ind on ds."""
    import warnings

    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            out = ind(ds=ds, **_ym_kwargs(ind))
    except Exception as err:  # noqa: BLE001  (compared with the CPU run's)
        return None, err
    return (out if isinstance(out, tuple) else (out,)), None


def _ym_renames():
    """YAML key -> core registry key, for the entries that only rename a
    core indicator (``base:`` and nothing else)."""
    import json
    import pathlib

    import xclim_tpu_torch

    data = pathlib.Path(xclim_tpu_torch.__file__).parent / "data"
    out = {}
    for m in YM_MODULES:
        defs = json.loads((data / f"{m}.json").read_text())["indicators"]
        for ident, d in defs.items():
            if d and set(d) == {"base"}:
                out[f"{m}.{ident.upper()}"] = d["base"].upper()
    return out


def phase_yaml_modules(device, card, record):
    """Every indicator of the YAML modules icclim, anuclim and cf (131) on
    the card at 128 x 128 cells x 30 noleap years, with every variable they
    read and the percentile inputs from percentile_doy over the series:
    each call's seconds (one warm-up, then one timed run) and segred/spells
    launches (no twin on the card); its outputs held to its CPU run on an
    8 x 8 crop (the same percentiles, cropped); an entry that only renames
    a core indicator equal to that indicator's card output; an entry that
    refuses the inputs refuses them on both devices with the same error.
    Returns the inputs."""
    import torch

    import xclim_tpu_torch.indicators  # noqa: F401  (the YAML modules)
    from xclim_tpu_torch.core.indicator import registry

    a = _yaml_inputs(device)
    t0 = time.perf_counter()
    dss = _yaml_datasets(a)
    torch.cuda.synchronize()
    _log(f"[yaml] inputs: {len(a)} variables ({YM_YEARS * 365}, {YM_SIDE}, "
         f"{YM_SIDE}) float32, {a['tas'].data.numel() * 4 / 1e9:.3f} GB each; "
         f"the four percentile inputs in {time.perf_counter() - t0:.3f} s")
    crops = {m: _ym_crop(ds) for m, ds in dss.items()}
    renames = _ym_renames()
    keys = sorted(k for k in registry if k.split(".")[0] in YM_MODULES)
    if len(keys) != 131:
        raise AssertionError(f"{len(keys)} YAML indicators, expected 131")
    failed, total, refused = [], 0.0, []
    launches = {"segred": 0, "spells": 0}
    for key in keys:
        m = key.split(".")[0]
        ind = registry[key]
        _ym_call(ind, dss[m])  # warm-up
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        out, err = _ym_call(ind, dss[m])
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        counts = {k: v for k, v in _counts().items() if v}
        want, cerr = _ym_call(ind, crops[m])
        if err is not None or cerr is not None:
            if err is None or cerr is None or type(err) is not type(cerr) \
                    or str(err) != str(cerr):
                failed.append(f"{key}: card {err!r}, cpu {cerr!r}")
            else:
                refused.append(key)
                _log(f"[yaml] {key}: refuses the inputs on the card and on "
                     f"the CPU alike ({type(err).__name__}: {str(err)[:80]})")
            continue
        total += sec
        if any(k.endswith("_twin") for k in counts):
            raise AssertionError(f"{key} on the card called a twin: {counts}")
        for k, v in counts.items():
            if k in record:
                record[k]["paths"][f"yaml {key}"] = v
            if k in launches:
                launches[k] += v
        errs = []
        try:
            for i, (g, w) in enumerate(zip(out, want)):
                got = g.isel(lat=slice(0, YM_CROP), lon=slice(0, YM_CROP))
                if not bool(torch.isfinite(g.data.float()).any()):
                    raise AssertionError(f"{key} [{i}]: no finite value")
                # counts exactly; floats within RTOL, as the CPU tests
                errs.append(_compare(f"{key} [{i}] cpu vs card", got.data,
                                     w.data, rtol=RTOL, atol=0.0))
            if key in renames:
                core, _ = _ym_call(registry[renames[key]], dss[m])
                for i, (g, c) in enumerate(zip(out, core)):
                    _compare(f"{key} [{i}] vs {renames[key]}", g.data, c.data,
                             rtol=0.0, atol=0.0)
        except AssertionError as exc:
            failed.append(str(exc))
        _log(f"[yaml] {key} {[tuple(o.shape) for o in out]} on {card}: "
             f"{sec:.4f} s; launches {json.dumps(counts)}; {YM_CROP}x{YM_CROP} "
             f"crop: CPU run max_abs_err {[float(f'{e:.3g}') for e in errs]}"
             + (f"; equal to {renames[key]}" if key in renames else ""))
        del out, want
    _log(f"[yaml] {len(keys) - len(refused)} calls: {total:.3f} s in all; "
         f"segred {launches['segred']} and spells {launches['spells']} "
         f"launches; {len(refused)} refuse the inputs on both devices "
         f"({', '.join(refused)})")
    if failed:
        raise AssertionError("YAML indicators disagree:\n" + "\n".join(failed))
    if not launches["segred"] or not launches["spells"]:
        raise AssertionError(f"the YAML indicators launched {launches}")
    del dss, crops
    torch.cuda.empty_cache()
    return a


CLI_VARS = ("tas", "tasmax", "tasmin", "pr")
#: the command line's chain: ten icclim indicators after the data flags
#: (which, as in the reference, replace what earlier commands merged)
CLI_CHAIN = ("icclim.TG", "icclim.TXx", "icclim.TNn", "icclim.SU",
             "icclim.FD", "icclim.TR", "icclim.GD4", "icclim.CDD",
             "icclim.CWD", "icclim.RX5day")


def _write_classic(path, a):
    """The CLI variables of `a` as a classic (64-bit offset) NetCDF file
    written by scipy: the host values written, by name."""
    import numpy as np
    from scipy.io import netcdf_file

    host = {k: a[k].values for k in CLI_VARS}
    t = a["tas"].time
    with netcdf_file(str(path), "w", version=2) as f:
        f.createDimension("time", len(t))
        f.createDimension("lat", YM_SIDE)
        f.createDimension("lon", YM_SIDE)
        tv = f.createVariable("time", "f8", ("time",))
        tv[:] = np.arange(len(t), dtype=np.float64)
        tv.units = b"days since 1981-01-01"
        tv.calendar = b"noleap"
        for c in ("lat", "lon"):
            cv = f.createVariable(c, "f8", (c,))
            cv[:] = a["tas"].coords[c]
        for k, x in host.items():
            v = f.createVariable(k, "f4", ("time", "lat", "lon"))
            v[:] = x
            for name, val in a[k].attrs.items():
                setattr(v, name, val.encode())
    return host


def _cli_run(pipe):
    """The CLI's commands on a Pipeline: dataflags, then the chain (and the
    fused chain's run); returns the flag lines."""
    from xclim_tpu_torch.cli import get_indicator

    lines = pipe.dataflags()
    for name in CLI_CHAIN:
        pipe.indicator(get_indicator(name))
    pipe.run_fused()
    return lines


def phase_cli(device, card, record, a):
    """The command line's pipeline on the card: a classic NetCDF file of
    16384 cells x 10950 days (tas, tasmax, tasmin, pr; 2.87 GB, written by
    scipy in a temporary directory) opened by the native reader (values
    equal to what was written), moved to the card, the data flags and ten
    icclim indicators run plain and --fused (equal to each other; the
    indicators on an 8 x 8 crop equal to the pipeline's CPU run), the
    output written where h5py is installed; read, host to card, compute and
    write timed apart; the whole pipeline from the file once more, and
    through click's ``main`` where click is installed."""
    import importlib
    import os
    import tempfile

    import numpy as np
    import torch

    from xclim_tpu_torch.cli import Pipeline
    from xclim_tpu_torch.core.dataarray import ClimDataset
    from xclim_tpu_torch.io import netcdf, open_dataset, to_netcdf

    have = {}
    for pkg in ("yaml", "click", "h5py"):
        try:
            mod = importlib.import_module(pkg)
            have[pkg] = True
            _log(f"[install] {pkg}: {getattr(mod, '__version__', 'installed')}")
        except ImportError:
            have[pkg] = False
            _log(f"[install] {pkg}: missing")
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/in.nc"
        t0 = time.perf_counter()
        host = _write_classic(path, a)
        size = os.path.getsize(path)
        _log(f"[cli] wrote {path.split('/')[-1]}: {size / 1e9:.3f} GB classic "
             f"NetCDF (64-bit offsets) in {time.perf_counter() - t0:.3f} s")
        before = dict(netcdf.opens)
        t0 = time.perf_counter()
        ds_host = open_dataset(path, device="cpu")
        t_read = time.perf_counter() - t0
        if netcdf.opens["native"] != before["native"] + 1:
            raise AssertionError(f"the native reader did not serve the open: "
                                 f"{before} -> {netcdf.opens}")
        for k, x in host.items():
            if not np.array_equal(ds_host[k].values, x, equal_nan=True):
                raise AssertionError(f"{k}: read values differ from written")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ds_card = ClimDataset({k: v.to(device) for k, v in ds_host.items()},
                              dict(ds_host.attrs))
        torch.cuda.synchronize()
        t_h2d = time.perf_counter() - t0
        outs, secs, counts = {}, {}, {}
        for fused in (False, True):
            pipe = Pipeline(path, device=device, fused=fused)
            pipe.ds_in = ds_card
            _cli_run(pipe)  # warm-up
            pipe = Pipeline(path, device=device, fused=fused)
            pipe.ds_in = ds_card
            torch.cuda.synchronize()
            _reset_counts()
            t0 = time.perf_counter()
            lines = _cli_run(pipe)
            torch.cuda.synchronize()
            secs[fused] = time.perf_counter() - t0
            counts[fused] = {k: v for k, v in _counts().items() if v}
            outs[fused] = pipe.ds_out
            name = "cli chain" + (" --fused" if fused else "")
            for k, v in counts[fused].items():
                if k in record:
                    record[k]["paths"][name] = v
            if any(k.endswith("_twin") for k in counts[fused]):
                raise AssertionError(f"{name} called a twin: {counts[fused]}")
            if not counts[fused].get("segred") or not counts[fused].get("spells"):
                raise AssertionError(f"{name} launched {counts[fused]}")
        plain, fused_out = outs[False], outs[True]
        if list(plain.keys()) != list(fused_out.keys()):
            raise AssertionError(f"plain {list(plain.keys())} != fused "
                                 f"{list(fused_out.keys())}")
        for k in plain:
            _compare(f"cli {k} plain vs --fused", plain[k].data.float(),
                     fused_out[k].data.float(), rtol=0.0, atol=0.0)
        # the indicators on a crop against the pipeline's CPU run
        crop = ClimDataset({k: v.isel(lat=slice(0, YM_CROP),
                                      lon=slice(0, YM_CROP))
                            for k, v in ds_host.items()})
        cpipe = Pipeline(path, device="cpu")
        cpipe.ds_in = crop
        _cli_run(cpipe)
        errs = []
        for k, w in cpipe.ds_out.items():
            if w.data.dtype == torch.bool:
                continue  # flags reduced over the whole grid
            g = plain[k].isel(lat=slice(0, YM_CROP), lon=slice(0, YM_CROP))
            errs.append(_compare(f"cli {k} cpu vs card", g.data, w.data,
                                 rtol=RTOL, atol=0.0))
        t_write = None
        if have["h5py"]:
            t0 = time.perf_counter()
            to_netcdf(plain, f"{tmp}/out.nc")
            t_write = time.perf_counter() - t0
        n_flags = sum(v.data.dtype == torch.bool for v in plain.values())
        _log(f"[cli] read {t_read:.3f} s (native reader, {size / 1e9 / t_read:.3f}"
             f" GB/s), host -> card {t_h2d:.3f} s, compute plain "
             f"{secs[False]:.4f} s / --fused {secs[True]:.4f} s (dataflags for "
             f"{len(CLI_VARS)} variables, {n_flags} flags, + {len(CLI_CHAIN)} "
             f"indicators), write "
             + (f"{t_write:.3f} s" if t_write is not None else
                "not run (h5py missing)")
             + f" on {card}; launches plain {json.dumps(counts[False])}, "
             f"--fused {json.dumps(counts[True])}; plain == --fused; "
             f"{YM_CROP}x{YM_CROP} crop vs the CPU pipeline max_abs_err "
             f"{[float(f'{e:.3g}') for e in errs]}")
        _log("[cli] flags: " + "; ".join(lines))
        del ds_card, plain, fused_out, outs
        torch.cuda.empty_cache()
        # the whole pipeline from the file, opened to the card directly
        before = netcdf.opens["native"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipe = Pipeline(path, f"{tmp}/out2.nc" if have["h5py"] else None,
                        device=device)
        _cli_run(pipe)
        pipe.finish()
        torch.cuda.synchronize()
        t_all = time.perf_counter() - t0
        if netcdf.opens["native"] != before + 1:
            raise AssertionError("the native reader did not serve the "
                                 "pipeline's open")
        _log(f"[cli] the pipeline from the file: {t_all:.3f} s (open on the "
             f"card, flags, {len(CLI_CHAIN)} indicators"
             + (", write" if have["h5py"] else "") + ")")
        del pipe
        if have["click"]:
            from xclim_tpu_torch.cli import make_cli

            args = ["--device", str(device), "-i", path]
            if have["h5py"]:
                args += ["-o", f"{tmp}/out3.nc"]
            args += ["dataflags", *CLI_CHAIN]
            t0 = time.perf_counter()
            make_cli().main(args, standalone_mode=False)
            torch.cuda.synchronize()
            _log(f"[cli] click's main {' '.join(args[:2])} ... : "
                 f"{time.perf_counter() - t0:.3f} s")
            if have["h5py"]:
                back = open_dataset(f"{tmp}/out3.nc", device="cpu")
                _log(f"[cli] wrote and read back {len(back.keys())} outputs")
        else:
            _log("[cli] click missing: the command group was not run (the "
                 "pipeline it calls ran above)")
    torch.cuda.empty_cache()


#: analog metric -> (rtol, atol), card against the CPU run on the crop
#: (tests/test_torch_dataflags_analog.py states the same bounds against the
#: JAX package on unit-scale samples). The indicators here are in K and mm
#: (up to ~3000), so a difference of two float32 means rounds to ~eps times
#: the mean: the card may also stand within AN_F64_FACTOR times the CPU
#: float32 run's own largest distance from a float64 run of the crop.
AN_TOL = {"seuclidean": (1e-5, 0.0), "nearest_neighbor": (0.0, 1e-6),
          "zech_aslan": (0.0, 1e-5), "szekely_rizzo": (0.0, 2e-4),
          "mahalanobis": (1e-5, 0.0), "kolmogorov_smirnov": (0.0, 1e-6),
          "kldiv": (1e-5, 0.0), "friedman_rafsky": (0.0, 0.0)}
AN_F64_FACTOR = 4.0


def _analog_check(method, got, target_c, cand_c):
    """The card's metric on the crop against the CPU's float32 and float64
    runs: within AN_TOL of the float32 run, or no farther from the float64
    run than AN_F64_FACTOR times the float32 run is. Returns (card vs
    float32, card vs float64, float32 vs float64) max abs errors."""
    import torch

    from xclim_tpu_torch import analog

    w32 = analog.spatial_analogs(target_c, cand_c, method=method).data
    w64 = analog.spatial_analogs(target_c.astype(torch.float64),
                                 cand_c.astype(torch.float64),
                                 method=method).data.double()
    g = got.double()
    e32 = float((g - w32.double()).abs().max())
    e64 = float((g - w64).abs().max())
    own = float((w32.double() - w64).abs().max())
    rtol, atol = AN_TOL[method]
    within = bool(((g - w32.double()).abs()
                   <= atol + rtol * w32.double().abs()).all())
    if not torch.equal(torch.isnan(g), torch.isnan(w32.double())) or not (
            within or e64 <= AN_F64_FACTOR * own):
        raise AssertionError(f"spatial_analogs {method} cpu vs card: max abs "
                             f"err {e32:.3g} (rtol {rtol}, atol {atol}); vs "
                             f"float64 {e64:.3g}, the CPU's own {own:.3g}")
    return e32, e64, own


#: utils.profiling.profile around atmos.tg_mean on the card, in a fresh
#: process: after a torch.profiler session of about a million kernel
#: launches (the fire phase's traces), later sessions in the same process
#: record no device activity (a 1.3 M-launch session, then 0 kernel events;
#: after 300 k, 1 of 2)
_PROFILE_PROBE = """
import glob, json, tempfile
import torch
from xclim_tpu_torch.core.calendar import date_range
from xclim_tpu_torch.core.dataarray import ClimArray
from xclim_tpu_torch.indicators import atmos
from xclim_tpu_torch.utils import profile

t = date_range("1981-01-01", periods=3650, calendar="noleap")
tas = ClimArray(torch.randn(3650, 128, 128, device="cuda") + 285.0,
                ("time", "lat", "lon"), {"time": t},
                {"units": "K", "standard_name": "air_temperature",
                 "cell_methods": "time: mean"}, "tas")
atmos.tg_mean(tas, freq="MS")
with tempfile.TemporaryDirectory() as tmp:
    with profile(tmp):
        atmos.tg_mean(tas, freq="MS")
    (trace,) = glob.glob(tmp + "/trace-*.json")
    events = json.loads(open(trace).read())["traceEvents"]
print(json.dumps({"events": len(events),
                  "kernels": sum(e.get("cat") == "kernel" for e in events)}))
"""


def _profile_trace_kernels() -> int:
    """Kernel events in the Chrome trace utils.profiling.profile writes
    around atmos.tg_mean on the card, in a fresh process (_PROFILE_PROBE)."""
    import os

    res = subprocess.run([sys.executable, "-c", _PROFILE_PROBE],
                         cwd=os.path.dirname(os.path.abspath(__file__)),
                         capture_output=True, text=True, timeout=300)
    if res.returncode != 0:
        raise AssertionError(f"profile probe failed:\n{res.stderr[-2000:]}")
    return json.loads(res.stdout.strip().splitlines()[-1])["kernels"]


def phase_flags_analogs_scale(device, card, a):
    """At 16384 cells x 30 years (the YAML phase's inputs): data_flags for
    tas, tasmax, tasmin and pr and ecad_compliant, each flag on an 8 x 8
    crop equal to its CPU run; spatial_analogs of one target cell (30
    annual samples x 3 indicators) against the 16384 cells with each
    metric, the crop against its CPU run; sharded_jit(atmos.tg_mean) on the
    (1, 1) mesh equal to the plain call; utils.profiling.profile's trace and
    timed's synced seconds."""
    import torch

    from xclim_tpu_torch import analog
    from xclim_tpu_torch.core import dataflags
    from xclim_tpu_torch.core.dataarray import ClimArray, ClimDataset, concat
    from xclim_tpu_torch.indicators import atmos
    from xclim_tpu_torch.parallel import sharded_jit, space_mesh
    from xclim_tpu_torch.utils import timed

    ds = ClimDataset({k: a[k] for k in CLI_VARS})
    crop = ClimDataset({k: v.isel(lat=slice(0, YM_CROP),
                                  lon=slice(0, YM_CROP)).to("cpu")
                        for k, v in ds.items()})
    for name in CLI_VARS:
        sec, runs = _timed(lambda n=name: dataflags.data_flags(ds[n], ds),
                           reps=1)
        full = dataflags.data_flags(ds[name], ds, dims=None)
        want = dataflags.data_flags(crop[name], crop, dims=None)
        raised = []
        for k, w in want.items():
            g = full[k]
            if (g is None) != (w is None):
                raise AssertionError(f"{name} {k}: card {g}, cpu {w}")
            if w is None:
                continue
            gc = g.isel(lat=slice(0, YM_CROP), lon=slice(0, YM_CROP))
            if not torch.equal(gc.data.cpu(), w.data):
                raise AssertionError(f"{name} {k}: flags differ on the crop "
                                     f"({int((gc.data.cpu() != w.data).sum())})")
            if bool(g.data.any()):
                raised.append(k)
        _log(f"[flags] data_flags({name}) on {card}: {sec:.4f} s (after a "
             f"warm-up); {len(want)} flags, raised: {raised or 'none'}; "
             f"{YM_CROP}x{YM_CROP} crop equal to the CPU run")
    sec, _ = _timed(lambda: dataflags.ecad_compliant(ds), reps=1)
    ecad = dataflags.ecad_compliant(ds, dims=None, append=False)
    want = dataflags.ecad_compliant(crop, dims=None, append=False)
    if not torch.equal(ecad.isel(lat=slice(0, YM_CROP), lon=slice(
            0, YM_CROP)).data.cpu(), want.data):
        raise AssertionError("ecad_compliant differs on the crop")
    _log(f"[flags] ecad_compliant on {card}: {sec:.4f} s; "
         f"{float(ecad.data.float().mean()) * 100:.2f} % of values pass; crop "
         f"equal to the CPU run")

    # spatial analogs: 30 annual samples x 3 indicators at every cell
    inds = [atmos.tg_mean(a["tas"], freq="YS"), atmos.tx_max(a["tasmax"], freq="YS"),
            atmos.precip_accumulation(a["pr"], freq="YS")]
    cand = concat(inds, "variables")  # (variables, time, lat, lon)
    cand = cand.transpose("time", "variables", "lat", "lon")
    cand.data = cand.data.contiguous()
    target = ClimArray(cand.data[:, :, YM_SIDE // 2, YM_SIDE // 3],
                       ("time", "variables"), {"time": cand.coords["time"]},
                       {}, "target")
    cand_c = cand.isel(lat=slice(0, YM_CROP), lon=slice(0, YM_CROP)).to("cpu")
    target_c = target.to("cpu")
    for method, (rtol, atol) in AN_TOL.items():
        if method == "friedman_rafsky":
            # a scipy loop over the cells on the host: one run, no warm-up
            reps = 1
            t0 = time.perf_counter()
            out = analog.spatial_analogs(target, cand, method=method)
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
        else:
            reps = 3
            sec, runs = _timed(lambda m=method: analog.spatial_analogs(
                target, cand, method=m), reps=reps)
            out = analog.spatial_analogs(target, cand, method=method)
        if tuple(out.shape) != (YM_SIDE, YM_SIDE) or out.data.device != device \
                or not bool(torch.isfinite(out.data).all()):
            raise AssertionError(f"{method}: {tuple(out.shape)} on "
                                 f"{out.data.device}, finite "
                                 f"{bool(torch.isfinite(out.data).all())}")
        e32, e64, own = _analog_check(method, out.data[:YM_CROP, :YM_CROP].cpu(),
                                      target_c, cand_c)
        _log(f"[analog] {method} ({YM_YEARS} x 3 target, {YM_SIDE ** 2} "
             f"cells) on {card}: {sec:.4f} s ({'one run' if reps == 1 else 'median of 3 after a warm-up'}"
             f"); crop: card vs CPU float32 max_abs_err "
             f"{e32:.3g} (rtol {rtol}, atol {atol}), card vs float64 "
             f"{e64:.3g}, CPU float32 vs float64 {own:.3g}")
    del inds, cand, cand_c

    # scale: the (1, 1) mesh, the profiler, timed
    tas = a["tas"]
    mesh = space_mesh()
    if mesh.shape != (1, 1):
        raise AssertionError(f"one card, mesh {mesh.shape}")
    plain = atmos.tg_mean(tas, freq="MS")
    _reset_counts()
    sharded = sharded_jit(lambda x: atmos.tg_mean(x, freq="MS"), mesh)(tas)
    torch.cuda.synchronize()
    counts = {k: v for k, v in _counts().items() if v}
    _compare("sharded_jit(atmos.tg_mean) vs atmos.tg_mean", sharded.data,
             plain.data, rtol=0.0, atol=0.0)
    sec, _ = _timed(lambda: sharded_jit(lambda x: atmos.tg_mean(x, freq="MS"),
                                        mesh)(tas))
    sec_plain, _ = _timed(lambda: atmos.tg_mean(tas, freq="MS"))
    kernels = _profile_trace_kernels()
    with timed("atmos.tg_mean") as t:
        t["sync"] = atmos.tg_mean(tas, freq="MS")
    if kernels == 0 or t["seconds"] <= 0:
        raise AssertionError(f"profile: {kernels} kernel events; timed "
                             f"{t['seconds']}")
    _log(f"[scale] sharded_jit(atmos.tg_mean) on the {mesh.shape} mesh on "
         f"{card}: {sec:.4f} s (median of 3; plain call {sec_plain:.4f} s), "
         f"equal to the plain call; launches {json.dumps(counts)}; "
         f"profile() wrote a Chrome trace with {kernels} kernel events (a "
         f"fresh process); timed() {t['seconds']:.4f} s")
    del plain, sharded
    torch.cuda.empty_cache()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; the port's "
              "kernels need an NVIDIA GPU", file=sys.stderr)
        return 2
    import xclim_tpu_torch

    start = time.perf_counter()
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _log(f"torch {torch.__version__} cuda {torch.version.cuda} "
         f"python {sys.version.split()[0]}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    _log(f"card: {card}")
    _log(f"device: {torch.cuda.get_device_name(0)}, "
         f"{torch.cuda.device_count()} visible")
    if sys.argv[1:] == ["--kernel-times"]:
        _log(json.dumps({"package": xclim_tpu_torch.__file__,
                         "ms": kernel_times(device)}))
        return 0

    # the build targets: read here, so that --kernel-times also runs
    # against a checkout older than _build.TARGETS
    from xclim_tpu_torch.ops import _build

    record = {}
    _build.build(_build.TARGETS)
    for target in _build.TARGETS:
        _build.load(target)
        info = _build.build_info[target]
        _log(f"[build] {target}: {info['seconds']:.2f} s")
        for line in info["log"].splitlines():
            if ("ptxas" in line and "Used" in line) or "spill" in line:
                _log(f"[build]   {line.strip()}")
        record[target] = {
            "name": target, "route": "cuda",
            "source": "xclim_tpu_torch/csrc/" + _build.source(target).name,
            "launches": 0, "max_abs_err": 0.0, "ms": None, "plain_ms": None,
            "bound_ms": None, "bound_by": None, "library_ms": None,
            "paths": {}}

    def run(phase, *args):
        t0 = time.perf_counter()
        out = phase(*args)
        _log(f"[wall] {phase.__name__}: {time.perf_counter() - t0:.1f} s")
        return out

    series = run(phase_slice, device, card, record)
    run(phase_cpu_vs_card, series)
    del series
    torch.cuda.empty_cache()
    tas = run(phase_tg_mean, device, card, record)
    run(phase_tg_mean_cpu_vs_card, tas)
    del tas
    torch.cuda.empty_cache()
    tasmax = run(phase_percentiles, device, card, record)
    run(phase_percentiles_cpu_vs_card, tasmax)
    del tasmax
    torch.cuda.empty_cache()
    ens = run(phase_ensembles, device, card, record)
    run(phase_ensembles_cpu_vs_card, ens)
    del ens
    torch.cuda.empty_cache()
    crop = run(phase_spells_indices, device, card, record)
    run(phase_spells_indices_cpu_vs_card, crop)
    del crop
    torch.cuda.empty_cache()
    dqm_series, dqm_scen = run(phase_dqm, device, card, record)
    run(phase_dqm_cpu_vs_card, dqm_series)
    run(phase_sdba_rest, device, card, dqm_series, dqm_scen, record)
    del dqm_series, dqm_scen
    torch.cuda.empty_cache()
    crop = run(phase_chain, device, card, record)
    run(phase_chain_cpu_vs_card, crop)
    del crop
    torch.cuda.empty_cache()
    run(phase_index_breadth, device, card, record)
    run(phase_fire, device, card)
    run(phase_land_seaice_generic, device, card, record)
    run(phase_calendar, device, card)
    a = run(phase_yaml_modules, device, card, record)
    run(phase_cli, device, card, record, a)
    run(phase_flags_analogs_scale, device, card, a)
    del a
    torch.cuda.empty_cache()
    _log(f"[wall] chip_smoke total: {time.perf_counter() - start:.1f} s")

    _log(json.dumps({"kernels": list(record.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
