"""Reusable pytest fixtures for downstream test suites
(reference: xclim:src/xclim/testing/conftest.py — the reference ships its
fixtures so dependent packages can ``pytest_plugins = ["xclim.testing"]``).

Use from a downstream conftest.py:

    pytest_plugins = ["xclim_tpu_torch.testing.fixtures"]

Each ``<var>_series`` fixture returns a factory
``make(values, start=..., freq=..., calendar=..., units=..., device=...)
-> ClimArray`` with CF attrs drawn from the official variable vocabulary
(``device`` default: :func:`xclim_tpu_torch.default_device`).
"""

from __future__ import annotations

import pytest

from xclim_tpu_torch.testing.helpers import test_timeseries

__all__ = [
    "evspsblpot_series",
    "hurs_series",
    "pr_series",
    "prsn_series",
    "q_series",
    "sfcWind_series",
    "snd_series",
    "snw_series",
    "tas_series",
    "tasmax_series",
    "tasmin_series",
    "timeseries",
]


@pytest.fixture
def timeseries():
    """The raw synthetic-series factory."""
    return test_timeseries


def _series_fixture(variable, units=None, start="2000-07-01"):
    """Default start matches the reference's test_timeseries
    (xclim:src/xclim/testing/helpers.py:166, "2000-07-01"); the pr/q/swe
    fixtures override it to "1/1/2000" exactly as the reference conftest does
    (xclim:tests/conftest.py:136,:160,:335)."""

    @pytest.fixture(name=f"{variable}_series")
    def _fix():
        def _make(values, start=start, freq="D", calendar="standard",
                  units=units, device=None):
            return test_timeseries(values, variable=variable, start=start,
                                   freq=freq, calendar=calendar, units=units,
                                   device=device)

        return _make

    return _fix


tas_series = _series_fixture("tas")
tasmax_series = _series_fixture("tasmax")
tasmin_series = _series_fixture("tasmin")
pr_series = _series_fixture("pr", start="2000-01-01")
prsn_series = _series_fixture("prsn")
q_series = _series_fixture("q", start="2000-01-01")
snd_series = _series_fixture("snd")
snw_series = _series_fixture("snw")
hurs_series = _series_fixture("hurs")
sfcWind_series = _series_fixture("sfcWind", units="km h-1")
evspsblpot_series = _series_fixture("evspsblpot")
