"""The port's ``indices/fire/`` (CFFWIS, KBDI, Griffiths, FFDI, the fire
season) and its seven fire indicators against the JAX package's, on the
same numpy inputs: seeded daily fields of 3 noleap years over 4 latitudes
(one per day-length band) x 8 longitudes, with a seasonal cycle that opens
and closes a fire season every year, half the days dry and snow in the
cold season; and the published test vectors of the reference's
``tests/test_fire.py`` (read from its parametrize marks).

Bounds. Masks, latches and counts are equal. Elementwise terms hold to
``RTOL`` (1e-6) relative. Stated exceptions:

- ``REC_TOL`` (3e-6 of each output's largest value): the codes are a
  recurrence over days. XLA:CPU and torch evaluate exp, log and pow by
  different polynomials (an ulp apart) and XLA contracts ``a*b + c`` into
  FMAs, so every day adds an ulp-sized difference to the carry. FFMC
  relaxes toward its equilibrium moisture and DMC/DC are reset by rain, so
  the difference does not grow with time: over 3 and 12 years it stays
  within 2 ulps of DC's largest value, 8.5 of DMC's and 4.5 of FFMC's;
  ISI, BUI, FWI and DSR raise the codes to powers up to 1.77 and reach 20
  ulps (1.3e-6) of their largest values. The thresholds that read the
  carry (``mo < ed``, ``mo < ew``) join continuous branches, so a flip
  there moves the result by rounding only; DMC's ``b`` jumps at 33 and 65,
  which no code of these inputs lands within rounding of. Values near 0
  (a code just reset by rain) are held by the same absolute bound.
- ``CFFWIS_FWI_ATOL`` (5e-4, ``xclim_tpu_torch.testing``) besides: FWI's
  last step exp(2.72 (0.434 ln f)^0.647) for f > 1 is Hoelder-continuous
  with exponent 0.647 at f = 1, so a float32 rounding of f by 16 ulps of 1
  there moves FWI by 3.3e-4.
- ``PUBLISHED_ATOL`` (2e-5): the reference's hand-calculated KBDI and
  Griffiths values, as its own test holds them.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import test_fire as ref_fire
import xclim_tpu.indicators.atmos as jatmos
from xclim_tpu.core.calendar import date_range as jdate_range
from xclim_tpu.core.dataarray import ClimArray as JClimArray
from xclim_tpu.indices import fire as jfire
from xclim_tpu.indices.fire import _cffwis as j_cffwis
from xclim_tpu_torch.indicators import atmos
from xclim_tpu_torch.indices import fire
from xclim_tpu_torch.indices.fire import _cffwis, _ffdi
from xclim_tpu_torch.testing import CFFWIS_FWI_ATOL, check_cffwis

from test_torch_converters import _marks, close, to_port

RTOL = 1e-6
REC_TOL = 3e-6
PUBLISHED_ATOL = 2e-5
YEARS = 3
NT = 365 * YEARS
LAT = np.array([-40.0, -20.0, 20.0, 50.0])
LON = np.arange(8.0)
K = 273.15


def _grid(x, name, units, attrs=None, coords=None):
    t = jdate_range("2000-01-01", periods=NT, calendar="noleap")
    j = JClimArray(jnp.asarray(x), ("time", "lat", "lon"),
                   coords or {"time": t, "lat": LAT, "lon": LON},
                   dict({"units": units}, **(attrs or {})), name)
    return j, to_port(j)


@pytest.fixture(scope="module")
def fields():
    rng = np.random.default_rng(10)
    shape = (NT, len(LAT), len(LON))
    doy = np.arange(NT) % 365
    # summer in each hemisphere's own half of the year
    season = np.cos(2 * np.pi * (doy - 200) / 365)[:, None, None] \
        * np.sign(LAT)[None, :, None]
    tas = K + 10 + 12 * season + rng.normal(0, 3, shape)
    pr = rng.gamma(0.6, 6, shape) * (rng.random(shape) < 0.5)
    hurs = np.clip(rng.normal(65, 18, shape), 5, 100)
    ws = np.abs(rng.normal(4, 2.5, shape))
    snd = np.where(season < -0.4, rng.uniform(0.02, 0.4, shape), 0.0)
    snd[rng.random(shape) < 0.05] = 0.0
    out = {
        "tas": _grid(tas.astype(np.float32), "tas", "K",
                     {"standard_name": "air_temperature"}),
        "tasmax": _grid((tas + 5).astype(np.float32), "tasmax", "K",
                        {"standard_name": "air_temperature"}),
        "pr": _grid((pr / 86400).astype(np.float32), "pr", "kg m-2 s-1",
                    {"standard_name": "precipitation_flux"}),
        "hurs": _grid(hurs.astype(np.float32), "hurs", "%"),
        "sfcWind": _grid(ws.astype(np.float32), "sfcWind", "m s-1"),
        "snd": _grid(snd.astype(np.float32), "snd", "m",
                     {"standard_name": "surface_snow_thickness"}),
    }
    return out


def _side(fields, k):
    return {name: pair[k] for name, pair in fields.items()}


def close_rec(got, want):
    """close() with REC_TOL of each output's largest value as the bound
    (plus CFFWIS_FWI_ATOL for FWI)."""
    if isinstance(want, tuple):
        for g, w in zip(got, want):
            close_rec(g, w)
        return
    scale = float(np.nanmax(np.abs(np.asarray(want.data, np.float64))))
    close(got, want, rtol=0.0, atol=REC_TOL * scale + (
        CFFWIS_FWI_ATOL if want.name == "fwi" else 0.0))


# -- cffwis_indices: every branch of fire_weather_calc ------------------------

_LAT2D = (np.linspace(-50, 60, 32).reshape(4, 8)).astype(np.float64)
_CODES0 = {"dc0": np.linspace(5, 400, 32, dtype=np.float32).reshape(4, 8),
           "dmc0": np.linspace(1, 60, 32, dtype=np.float32).reshape(4, 8),
           "ffmc0": np.linspace(40, 95, 32, dtype=np.float32).reshape(4, 8)}

CFFWIS_CASES = {
    "always_on": {},
    "always_on_lat_scalar": {"lat": -25.0},
    "always_on_lat_2d": {"lat": _LAT2D},
    "initial_codes": dict(_CODES0),
    "wf93": {"season_method": "WF93"},
    "la08": {"season_method": "LA08", "snd": True},
    "gfwed": {"season_method": "GFWED", "snd": True},
    "wf93_overwintering": {"season_method": "WF93", "overwintering": True},
    "wf93_dry_start": {"season_method": "WF93", "dry_start": "CFS"},
    "wf93_overwintering_dry_start": {"season_method": "WF93",
                                     "overwintering": True,
                                     "dry_start": "CFS"},
    "wf93_no_initial_start_up": {"season_method": "WF93",
                                 "initial_start_up": False},
    "gfwed_overwintering_codes": dict(_CODES0, season_method="GFWED",
                                      snd=True, overwintering=True),
    "la08_dry_start_codes": dict(_CODES0, season_method="LA08", snd=True,
                                 dry_start="CFS", initial_start_up=False),
    "wf93_thresholds": {"season_method": "WF93", "temp_start_thresh": 10.0,
                        "temp_end_thresh": 3.0, "temp_condition_days": 5},
}


def _run_cffwis(mod, a, kw):
    kw = dict(kw)
    if kw.pop("snd", False):
        kw["snd"] = a["snd"]
    return mod.cffwis_indices(a["tas"], a["pr"], a["sfcWind"], a["hurs"],
                              **kw)


@pytest.mark.parametrize("case", sorted(CFFWIS_CASES))
def test_cffwis_indices_against_reference(fields, case):
    kw = CFFWIS_CASES[case]
    want = _run_cffwis(jfire, _side(fields, 0), kw)
    got = _run_cffwis(fire, _side(fields, 1), kw)
    assert type(got).__name__ == "CFFWIS" and got._fields == want._fields
    close_rec(tuple(got), tuple(want))


def test_cffwis_without_a_lat_coordinate_takes_45_degrees(fields):
    """No ``lat`` argument and no ``lat`` coordinate: 45 degrees."""
    def strip(a):
        return {k: _without_lat(v) for k, v in a.items()}

    want = _run_cffwis(jfire, strip(_side(fields, 0)), {})
    got = _run_cffwis(fire, strip(_side(fields, 1)), {})
    close_rec(tuple(got), tuple(want))
    at45 = _run_cffwis(fire, _side(fields, 1), {"lat": 45.0})
    for g, w in zip(got, at45):
        torch.testing.assert_close(g.data, w.data, rtol=0, atol=0,
                                   equal_nan=True)


def _without_lat(a):
    out = a.copy()
    out.coords = {k: v for k, v in a.coords.items() if k != "lat"}
    return out


def test_cffwis_takes_the_reference_state_and_mask(fields):
    """Last season's codes and a season mask, as the JAX package's
    ClimArrays, feed the port unchanged (no conversion by the caller)."""
    j, p = _side(fields, 0), _side(fields, 1)
    first = jfire.cffwis_indices(j["tas"], j["pr"], j["sfcWind"], j["hurs"])
    state = {f"{k}0": getattr(first, k).isel(time=NT - 1)
             for k in ("dc", "dmc", "ffmc")}
    mask = jfire.fire_season(j["tas"], method="WF93")
    want = jfire.cffwis_indices(j["tas"], j["pr"], j["sfcWind"], j["hurs"],
                                season_mask=mask, **state)
    got = fire.cffwis_indices(p["tas"], p["pr"], p["sfcWind"], p["hurs"],
                              season_mask=mask, **state)
    close_rec(tuple(got), tuple(want))


def test_drought_and_duff_moisture_codes(fields):
    j, p = _side(fields, 0), _side(fields, 1)
    for kw in ({}, {"season_method": "WF93", "overwintering": True},
               {"season_method": "GFWED", "snd": "snd", "dry_start": "CFS",
                "dc0": _CODES0["dc0"]}):
        kwj = {k: (j[v] if k == "snd" else v) for k, v in kw.items()}
        kwp = {k: (p[v] if k == "snd" else v) for k, v in kw.items()}
        close_rec(fire.drought_code(p["tas"], p["pr"], **kwp),
                  jfire.drought_code(j["tas"], j["pr"], **kwj))
    for kw in ({}, {"season_method": "WF93", "dry_start": "CFS",
                    "dmc0": _CODES0["dmc0"]}):
        close_rec(fire.duff_moisture_code(p["tas"], p["pr"], p["hurs"], **kw),
                  jfire.duff_moisture_code(j["tas"], j["pr"], j["hurs"], **kw))


def test_fire_weather_ufunc(fields):
    j, p = _side(fields, 0), _side(fields, 1)
    kw = {"season_method": "LA08", "overwintering": True}
    want = jfire.fire_weather_ufunc(tas=j["tas"], pr=j["pr"], hurs=j["hurs"],
                                    sfcWind=j["sfcWind"], snd=j["snd"], **kw)
    got = fire.fire_weather_ufunc(tas=p["tas"], pr=p["pr"], hurs=p["hurs"],
                                  sfcWind=p["sfcWind"], snd=p["snd"], **kw)
    assert list(got) == list(want)
    close_rec(tuple(got.values()), tuple(want.values()))


def test_overwintering_drought_code(fields):
    rng = np.random.default_rng(11)
    dc = rng.uniform(5, 700, (4, 8)).astype(np.float32)
    wpr = rng.uniform(0, 400, (4, 8)).astype(np.float32)
    coords = {"lat": LAT, "lon": LON}

    def pair(x, units):
        j = JClimArray(jnp.asarray(x), ("lat", "lon"), coords,
                       {"units": units}, "x")
        return j, to_port(j)

    (jd, pd), (jw, pw) = pair(dc, ""), pair(wpr, "mm")
    for kw in ({}, {"carry_over_fraction": 0.9,
                    "wetting_efficiency_fraction": 0.5, "min_dc": 20.0}):
        want = jfire.overwintering_drought_code(jd, jw, **kw)
        # 400 log(800 / Qs) cancels toward min_dc: RTOL of the scale
        close(fire.overwintering_drought_code(pd, pw, **kw), want, rtol=RTOL,
              atol=RTOL * float(np.max(np.asarray(want.data))))


# -- the fire season ----------------------------------------------------------


@pytest.mark.parametrize("kw", [
    {"method": "WF93"}, {"method": "LA08"}, {"method": "GFWED"},
    {"method": "WF93", "temp_start_thresh": "285 K",
     "temp_end_thresh": "40 degF", "temp_condition_days": 5},
    {"method": "GFWED", "snow_thresh": "2 cm", "snow_condition_days": 2},
], ids=lambda kw: "-".join(str(v) for v in kw.values()))
def test_fire_season_against_reference(fields, kw):
    j, p = _side(fields, 0), _side(fields, 1)
    snow = kw["method"] != "WF93"
    want = jfire.fire_season(j["tas"], snd=j["snd"] if snow else None, **kw)
    got = fire.fire_season(p["tas"], snd=p["snd"] if snow else None, **kw)
    assert got.data.dtype == torch.bool
    close(got, want, rtol=0.0)
    # the season opens and closes in every year and latitude
    m = got.values.reshape(YEARS, 365, -1)
    assert m.any(axis=1).all() and (~m).any(axis=1).all()


def test_latch_equals_the_scan():
    """The loop-free latch equals mask_t = (mask_{t-1} | su_t) & ~sd_t
    from False, on random start-up and shut-down days (both set on some)."""
    gen = torch.Generator().manual_seed(3)
    su = torch.rand((400, 64), generator=gen) < 0.05
    sd = torch.rand((400, 64), generator=gen) < 0.05
    su[:3] = sd[:3] = False
    mask = torch.zeros(64, dtype=torch.bool)
    want = []
    for i in range(400):
        mask = (mask | su[i]) & ~sd[i]
        want.append(mask)
    assert torch.equal(_cffwis._latch(su, sd), torch.stack(want))
    assert (su & sd).any() and torch.stack(want).any()


# -- the one-step functions and the derived indices ---------------------------


def _day(n=4096, seed=5):
    rng = np.random.default_rng(seed)
    return {"t": rng.uniform(-10, 40, n), "p": np.where(rng.random(n) < 0.5,
                                                        0.0, rng.gamma(0.7, 8, n)),
            "w": rng.uniform(0, 40, n), "h": rng.uniform(5, 100, n),
            "dl": rng.choice(_cffwis.DAY_LENGTHS.ravel(), n),
            "fl": rng.choice(_cffwis.DAY_LENGTH_FACTORS.ravel(), n),
            "ffmc": rng.uniform(0, 101, n), "dmc": rng.uniform(0, 150, n),
            "dc": rng.uniform(0, 900, n)}


STEPS = {
    "ffmc": lambda m, a: m._ffmc_step(a["t"], a["p"], a["w"], a["h"], a["ffmc"]),
    "dmc": lambda m, a: m._dmc_step(a["t"], a["p"], a["h"], a["dl"], a["dmc"]),
    "dc": lambda m, a: m._dc_step(a["t"], a["p"], a["fl"], a["dc"]),
    "isi": lambda m, a: m.initial_spread_index(a["w"], a["ffmc"]),
    "bui": lambda m, a: m.build_up_index(a["dmc"], a["dc"]),
    "fwi": lambda m, a: m.fire_weather_index(
        m.initial_spread_index(a["w"], a["ffmc"]),
        m.build_up_index(a["dmc"], a["dc"])),
    "dsr": lambda m, a: m.daily_severity_rating(a["ffmc"] / 2),
    "overwintered_dc": lambda m, a: m._overwintered_dc(
        a["dc"], a["p"] * 20, 0.75, 0.75, 15.0),
}


@pytest.mark.parametrize("name", sorted(STEPS))
def test_step_functions_against_reference(name):
    """One day from the same inputs: RTOL relative, and an absolute term of
    RTOL of the output's scale where a code cancels toward 0 (DC after
    heavy rain, FFMC near saturation); FWI with CFFWIS_FWI_ATOL besides."""
    a = {k: v.astype(np.float32) for k, v in _day().items()}
    a["dmc"][:8] = 0.0
    a["dc"][:4] = 0.0
    want = np.asarray(STEPS[name](j_cffwis, {k: jnp.asarray(v) for k, v in a.items()}),
                      np.float64)
    got = STEPS[name](_cffwis, {k: torch.as_tensor(v) for k, v in a.items()})
    got = got.numpy().astype(np.float64)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=RTOL * np.nanmax(np.abs(want)) + (
                                   CFFWIS_FWI_ATOL if name == "fwi" else 0.0),
                               equal_nan=True)


def test_hoisted_terms_give_the_step_functions_bits():
    """fire_weather_calc computes the carry-free terms for the whole series
    before its loop; the result is bit-equal to calling the one-step
    functions inside the loop (time x 64 cells: every elementwise op runs
    the same vector path on both)."""
    rng = np.random.default_rng(6)
    T, C = 200, 64
    a = {"t": rng.uniform(-5, 35, (T, C)), "p": rng.gamma(0.5, 6, (T, C))
         * (rng.random((T, C)) < 0.5), "w": rng.uniform(0, 30, (T, C)),
         "h": rng.uniform(10, 100, (T, C))}
    a = {k: torch.as_tensor(v.astype(np.float32)) for k, v in a.items()}
    dl = torch.as_tensor(rng.choice(_cffwis.DAY_LENGTHS.ravel(), (T, C))
                         .astype(np.float32))
    fl = torch.as_tensor(rng.choice(_cffwis.DAY_LENGTH_FACTORS.ravel(), (T, C))
                         .astype(np.float32))
    out = _cffwis.fire_weather_calc(a["t"], a["p"], a["h"], a["w"], dl, fl)
    dc = torch.full((C,), 15.0)
    dmc = torch.full((C,), 6.0)
    ffmc = torch.full((C,), 85.0)
    for i in range(T):
        dc = _cffwis._dc_step(a["t"][i], a["p"][i], fl[i], dc)
        dmc = _cffwis._dmc_step(a["t"][i], a["p"][i], a["h"][i], dl[i], dmc)
        ffmc = _cffwis._ffmc_step(a["t"][i], a["p"][i], a["w"][i], a["h"][i],
                                  ffmc)
        for name, v in (("DC", dc), ("DMC", dmc), ("FFMC", ffmc)):
            assert torch.equal(out[name][i], v), (name, i)


@pytest.fixture
def no_host_sync(monkeypatch):
    def forbidden(*a, **k):
        raise AssertionError("host sync inside a fire recurrence")

    monkeypatch.setattr(torch.Tensor, "item", forbidden)
    monkeypatch.setattr(torch.Tensor, "tolist", forbidden)
    monkeypatch.setattr(torch.Tensor, "__bool__", forbidden)


@pytest.mark.parametrize("kw", [
    {}, {"overwintering": True}, {"dry_start": "CFS"},
    {"overwintering": True, "dry_start": "CFS", "initial_start_up": False}],
    ids=["always_on", "overwintering", "dry_start", "both"])
def test_cffwis_loop_does_not_sync_with_the_host(no_host_sync, kw):
    """The carry stays a tensor: ``.item()``, ``.tolist()`` or ``bool()``
    of a tensor inside the loop would raise here."""
    gen = torch.Generator().manual_seed(4)
    T, C = 60, 8
    t = 15 + 10 * torch.randn((T, C), generator=gen)
    p = torch.rand((T, C), generator=gen) * 8
    h = 30 + 60 * torch.rand((T, C), generator=gen)
    w = 20 * torch.rand((T, C), generator=gen)
    dl = torch.full((T,), 12.0)
    fl = torch.full((T,), 1.39)
    mask = None
    if kw:
        mask = torch.zeros((T, C), dtype=torch.bool)
        mask[10:40] = True
    out = _cffwis.fire_weather_calc(t, p, h, w, dl, fl, season_mask=mask,
                                    **kw)
    assert out["FWI"].shape == (T, C)


def test_kbdi_loop_does_not_sync_with_the_host(no_host_sync):
    gen = torch.Generator().manual_seed(5)
    p = torch.rand((60, 8), generator=gen) * 4
    t = 25 + 5 * torch.randn((60, 8), generator=gen)
    out = _ffdi._kbdi_scan(p, t, torch.full((8,), 800.0), torch.zeros(8))
    assert out.shape == (60, 8)


# -- KBDI, Griffiths, FFDI ----------------------------------------------------


def test_kbdi_df_ffdi_against_reference(fields):
    """The kbdi -> df -> ffdi chain on the seeded fields; KBDI is a
    recurrence (REC_TOL), the drought factor and FFDI are elementwise over
    it and hold to REC_TOL of their scale too."""
    out = {}
    for k, mod in ((0, jfire), (1, fire)):
        a = _side(fields, k)
        kb = mod.keetch_byram_drought_index(a["pr"], a["tasmax"], "900 mm/yr")
        df = mod.griffiths_drought_factor(a["pr"], kb)
        dfd = mod.griffiths_drought_factor(a["pr"], kb, "discrete")
        ffdi = mod.mcarthur_forest_fire_danger_index(df, a["tasmax"],
                                                     a["hurs"], a["sfcWind"])
        out[k] = (kb, df, dfd, ffdi)
    close_rec(out[1], out[0])


def test_kbdi_with_initial_state_and_gridded_annual_precip(fields):
    j, p = _side(fields, 0), _side(fields, 1)
    pa = JClimArray(jnp.asarray(np.linspace(300, 2000, 32, dtype=np.float32)
                                .reshape(4, 8)), ("lat", "lon"),
                    {"lat": LAT, "lon": LON}, {"units": "mm/year"}, "pa")
    k0 = JClimArray(jnp.asarray(np.linspace(0, 200, 32, dtype=np.float32)
                                .reshape(4, 8)), ("lat", "lon"),
                    {"lat": LAT, "lon": LON}, {"units": "mm/day"}, "k0")
    close_rec(fire.keetch_byram_drought_index(p["pr"], p["tasmax"],
                                              to_port(pa), to_port(k0)),
              jfire.keetch_byram_drought_index(j["pr"], j["tasmax"], pa, k0))


def test_griffiths_windows_are_the_reference_gather():
    """The 20 window slices are shifted views of the zero-padded series:
    the same values as the reference's (T, 20, ...) gather, including the
    first 19 days' partial windows and a rain event on the last day."""
    rng = np.random.default_rng(8)
    p = (rng.gamma(0.5, 8, (90, 16)) * (rng.random((90, 16)) < 0.4))
    p[-1] = 30.0
    smd = rng.uniform(0, 150, (90, 16))
    p, smd = p.astype(np.float32), smd.astype(np.float32)
    for lim in (0, 1):
        want = np.asarray(jfire._ffdi._griffiths_df(jnp.asarray(p),
                                                    jnp.asarray(smd), lim))
        got = _ffdi._griffiths_df(torch.as_tensor(p), torch.as_tensor(smd),
                                  lim).numpy()
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * 10,
                                   equal_nan=True)


_KBDI = _marks(ref_fire.TestFFDIOracles.test_keetch_byram_drought_index)
_DF = _marks(ref_fire.TestFFDIOracles.test_griffiths_drought_factor)


@pytest.mark.parametrize("p,t,pa,k0,exp", _KBDI["p,t,pa,k0,exp"])
def test_kbdi_published_values(p, t, pa, k0, exp, pr_series, tasmax_series):
    pr = to_port(pr_series(np.asarray(p, dtype=float), units="mm/day"))
    tasmax = to_port(tasmax_series(np.asarray(t, dtype=float), units="degC"))
    pa_ = to_port(JClimArray(np.asarray(pa), (), attrs={"units": "mm/year"},
                             name="pa"))
    k0_ = to_port(JClimArray(np.asarray(k0), (), attrs={"units": "mm/day"},
                             name="k0"))
    out = fire.keetch_byram_drought_index(pr, tasmax, pa_, k0_)
    np.testing.assert_allclose(out.values[-1], exp, atol=PUBLISHED_ATOL)


@pytest.mark.parametrize("p, s, exp, test_discrete",
                         _DF["p, s, exp, test_discrete"])
def test_griffiths_published_values(p, s, exp, test_discrete, pr_series):
    pr = to_port(pr_series(np.asarray(p, dtype=float), units="mm/day"))
    smd = to_port(pr_series(np.asarray(s, dtype=float), units="mm/day"))
    df = fire.griffiths_drought_factor(pr, smd, "xlim").values[-1]
    np.testing.assert_allclose(df, exp, atol=PUBLISHED_ATOL)
    if test_discrete:
        dfd = fire.griffiths_drought_factor(pr, smd, "discrete").values[-1]
        np.testing.assert_allclose(dfd, round(exp), atol=PUBLISHED_ATOL)


def test_griffiths_published_sliding(pr_series):
    p = np.zeros(24)
    p[19] = 20.0
    pr = to_port(pr_series(p, units="mm/day"))
    smd = to_port(pr_series(20 * np.ones(24), units="mm/day"))
    exp = np.array([1.07024, 3.14744, 4.71645, 5.64112, 6.14665])
    df = fire.griffiths_drought_factor(pr, smd, "xlim").values
    assert np.isnan(df[:19]).all()
    np.testing.assert_allclose(df[19:], exp, atol=PUBLISHED_ATOL)


def test_mcarthur_ffdi_published(pr_series, tasmax_series, hurs_series,
                                 sfcWind_series):
    D = to_port(pr_series(np.arange(1.0, 11.0), units=""))
    T = to_port(tasmax_series(np.arange(30.0, 40.0), units="degC"))
    H = to_port(hurs_series(np.arange(10.0, 20.0)))
    V = to_port(sfcWind_series(np.arange(10.0, 20.0), units="km h-1"))
    exp = 2.0 * np.exp(-0.450 + 0.987 * np.log(np.arange(1.0, 11.0))
                       - 0.0345 * np.arange(10.0, 20.0)
                       + 0.0338 * np.arange(30.0, 40.0)
                       + 0.0234 * np.arange(10.0, 20.0))
    ffdi = fire.mcarthur_forest_fire_danger_index(D, T, H, V)
    np.testing.assert_allclose(ffdi.values, exp, rtol=1e-5)


# -- the indicators -----------------------------------------------------------

INDICATORS = {
    "cffwis_indices": lambda m, a: m.cffwis_indices(
        a["tas"], a["pr"], a["sfcWind"], a["hurs"]),
    "cffwis_gfwed": lambda m, a: m.cffwis(
        tas=a["tas"], pr=a["pr"], sfcWind=a["sfcWind"], hurs=a["hurs"],
        snd=a["snd"], season_method="GFWED", overwintering=True),
    "drought_code": lambda m, a: m.drought_code(
        a["tas"], a["pr"], season_method="WF93", dry_start="CFS"),
    "dmc": lambda m, a: m.dmc(a["tas"], a["pr"], a["hurs"]),
    "keetch_byram_drought_index": lambda m, a: m.keetch_byram_drought_index(
        a["pr"], a["tasmax"], "1200 mm/yr"),
    "df_ffdi": lambda m, a: m.ffdi(
        m.df(a["pr"], m.kbdi(a["pr"], a["tasmax"], "1200 mm/yr")),
        a["tasmax"], a["hurs"], a["sfcWind"]),
    "griffiths_discrete": lambda m, a: m.griffiths_drought_factor(
        a["pr"], m.kbdi(a["pr"], a["tasmax"], "1200 mm/yr"),
        limiting_func="discrete"),
}


@pytest.mark.parametrize("name", sorted(INDICATORS))
def test_fire_indicators_against_reference(fields, name):
    """Values within REC_TOL of their scale, and the same name, attrs
    (history but for its timestamp and package name) and coordinates."""
    want = INDICATORS[name](jatmos, _side(fields, 0))
    got = INDICATORS[name](atmos, _side(fields, 1))
    if isinstance(want, tuple):
        want, got = tuple(want), tuple(got)
    close_rec(got, want)


@pytest.mark.parametrize("method", ["WF93", "LA08", "GFWED"])
def test_fire_season_indicator(fields, method):
    j, p = _side(fields, 0), _side(fields, 1)
    snow = method != "WF93"
    want = jatmos.fire_season(j["tas"], snd=j["snd"] if snow else None,
                              method=method)
    got = atmos.fire_season(p["tas"], snd=p["snd"] if snow else None,
                            method=method)
    close(got, want, rtol=0.0)


# -- the float64 replay of a run's own days -----------------------------------


@pytest.mark.parametrize("case", ["always_on", "initial_codes", "la08",
                                  "wf93_overwintering", "wf93_dry_start",
                                  "la08_dry_start_codes"])
def test_cffwis_check_holds_each_branch_to_the_float64_replay(fields, case):
    """check_cffwis: every day of the CPU run within CFFWIS_RTOL (1e-5) of
    the float64 replay of that day from the run's own codes, plus
    CFFWIS_SCALE_TOL (2e-6) of the output's largest value (one day's
    float32 rounding: DMC's 43.43 (5.6348 - log(...)) and DC's
    dc0 - 400 log(...) cancel to ~5e-7 of their scale), FWI with
    CFFWIS_FWI_ATOL besides."""
    kw = dict(CFFWIS_CASES[case])
    p = _side(fields, 1)
    if kw.pop("snd", False):
        kw["snd"] = p["snd"]
    out = fire.cffwis_indices(p["tas"], p["pr"], p["sfcWind"], p["hurs"],
                              **kw)
    report = check_cffwis(out, p["tas"], p["pr"], p["sfcWind"], p["hurs"],
                          **kw)
    assert set(report) == {"replay", "dc", "dmc", "ffmc", "isi", "bui",
                           "fwi", "dsr"}
    assert max(v[0] for k, v in report.items() if k != "replay") > 0


@pytest.mark.parametrize("fault", ["value", "nan"])
def test_cffwis_check_refuses_a_faulty_run(fields, fault):
    """A DMC off by 1e-3 on one day, or a FFMC set to NaN, fails."""
    p = _side(fields, 1)
    out = list(fire.cffwis_indices(p["tas"], p["pr"], p["sfcWind"],
                                   p["hurs"]))
    k = 1 if fault == "value" else 2
    data = out[k].data.clone()
    data[400, 2, 3] = data[400, 2, 3] + 1e-3 if fault == "value" else np.nan
    out[k] = out[k].copy(data=data)
    with pytest.raises(AssertionError, match="dmc: 1 values beyond"
                       if fault == "value" else "ffmc: NaN patterns"):
        check_cffwis(out, p["tas"], p["pr"], p["sfcWind"], p["hurs"])


def test_cffwis_check_follows_the_run_across_dmcs_jump():
    """Two cells that start on a wet day from DMC 33 and from the next
    float32 above it take b's two branches (9.615 and 9.455) and stay
    apart by hundredths of a code until rain resets both; each is right,
    and the replay, which decides on the run's own value, holds both."""
    from xclim_tpu_torch.core.calendar import date_range
    from xclim_tpu_torch.core.dataarray import ClimArray

    T = 90
    t = date_range("2001-05-01", periods=T, calendar="noleap")
    rng = np.random.default_rng(9)

    def series(x, units):
        x = np.repeat(np.asarray(x, np.float32)[:, None], 2, axis=1)
        return ClimArray(torch.as_tensor(x), ("time", "cell"), {"time": t},
                         {"units": units}, "x")

    pr = np.where(rng.random(T) < 0.6, 0.0, rng.gamma(1, 6, T))
    pr[0] = 12.0
    args = (series(20 + 5 * rng.standard_normal(T), "degC"),
            series(pr, "mm/d"), series(rng.uniform(2, 25, T), "km/h"),
            series(rng.uniform(30, 90, T), "%"))
    dmc0 = np.array([33.0, np.nextafter(np.float32(33.0), np.float32(34.0))],
                    np.float32)
    out = fire.cffwis_indices(*args, dmc0=dmc0)
    dmc = out.dmc.values
    assert abs(dmc[0, 0] - dmc[0, 1]) > 0.05
    assert np.abs(dmc[:7, 0] - dmc[:7, 1]).min() > 1e-2
    check_cffwis(out, *args, dmc0=dmc0)


def _swap_winter_days(flags):
    su, sd, winter, winter_wet, winter_dry = flags
    return su, sd, winter, winter_dry, winter_wet


#: faults planted in the port's recurrence, each of which a replay built
#: from the port's own terms and transitions would share
PLANTED = {
    "dc_pe": ({}, lambda m: m.setattr(
        _cffwis, "_dc_terms",
        lambda t, p, fl, f=_cffwis._dc_terms: (f(t, p, fl)[0] * 1.001,)
        + f(t, p, fl)[1:])),
    "ffmc_equilibrium": ({}, lambda m: m.setattr(
        _cffwis, "_ffmc_terms",
        lambda *a, f=_cffwis._ffmc_terms: f(*a)[:4] + (f(*a)[4] + 0.01,)
        + f(*a)[5:])),
    "dmc_start": ({"season_method": "WF93"}, lambda m: m.setitem(
        _cffwis.default_params, "dmc_start", 6.001)),
    "dry_start_winter": ({"season_method": "WF93", "dry_start": "CFS"},
                         lambda m: m.setattr(
        _cffwis, "_season_flags",
        lambda *a, f=_cffwis._season_flags: _swap_winter_days(f(*a)))),
}


@pytest.mark.parametrize("fault", sorted(PLANTED))
def test_cffwis_check_refuses_a_planted_fault(fields, monkeypatch, fault):
    """The replay shares no code with indices.fire: a wrong hoisted term, a
    wrong start value or a wrong season transition in the port's run fails
    check_cffwis."""
    kw, plant = PLANTED[fault]
    p = _side(fields, 1)
    plant(monkeypatch)
    out = fire.cffwis_indices(p["tas"], p["pr"], p["sfcWind"], p["hurs"],
                              **kw)
    with pytest.raises(AssertionError, match="cffwis (dc|dmc|ffmc)"):
        check_cffwis(out, p["tas"], p["pr"], p["sfcWind"], p["hurs"], **kw)


@pytest.mark.parametrize("case", sorted(
    k for k in CFFWIS_CASES if "lat" not in k))
def test_one_code_runs_equal_the_full_run(fields, case):
    """drought_code and duff_moisture_code run their one code alone; each
    gives the bits of cffwis_indices' code on the same inputs."""
    kw = dict(CFFWIS_CASES[case])
    p = _side(fields, 1)
    if kw.pop("snd", False):
        kw["snd"] = p["snd"]
    full = fire.cffwis_indices(p["tas"], p["pr"], p["sfcWind"], p["hurs"],
                               **kw)
    codes = {k: kw.pop(k, None) for k in ("dc0", "dmc0", "ffmc0")}
    over = kw.pop("overwintering", False)
    dc = fire.drought_code(p["tas"], p["pr"], dc0=codes["dc0"],
                           overwintering=over, **kw)
    torch.testing.assert_close(dc.data, full.dc.data, rtol=0, atol=0,
                               equal_nan=True)
    if not over:
        dmc = fire.duff_moisture_code(p["tas"], p["pr"], p["hurs"],
                                      dmc0=codes["dmc0"], **kw)
        torch.testing.assert_close(dmc.data, full.dmc.data, rtol=0, atol=0,
                                   equal_nan=True)
