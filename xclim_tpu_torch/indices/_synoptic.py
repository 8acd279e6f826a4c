"""Synoptic indices (reference: xclim:src/xclim/indices/_synoptic.py)."""

from __future__ import annotations

import numpy as np
import torch

from xclim_tpu_torch.core.dataarray import ClimArray
from xclim_tpu_torch.core.units import convert_units_to, declare_units
from xclim_tpu_torch.ops.segments import weighted_window_sum

__all__ = ["jetstream_metric_woollings"]


def _lanczos_lowpass_weights(window: int, cutoff: float) -> np.ndarray:
    """Lanczos low-pass filter weights (Duchon 1979; the filter used by
    xclim:_synoptic.py:103)."""
    order = (window - 1) // 2 + 1
    nwts = 2 * order + 1
    w = np.zeros(nwts)
    n = nwts // 2
    w[n] = 2 * cutoff
    k = np.arange(1.0, n)
    sigma = np.sin(np.pi * k / n) * n / (np.pi * k)
    firstfactor = np.sin(2.0 * np.pi * cutoff * k) / (np.pi * k)
    w[n - 1:0:-1] = firstfactor * sigma
    w[n + 1:-1] = firstfactor * sigma
    return w[1:-1]


@declare_units(ua="[speed]")
def jetstream_metric_woollings(ua: ClimArray):
    """Strength and latitude of the jet stream (Woollings et al. 2010;
    xclim:_synoptic.py:24).

    ua: zonal wind with dims including ('time', 'lat'); already pressure- and
    longitude-averaged. Applies a 61-day Lanczos low-pass (10-day cutoff),
    then takes the latitude of maximum wind per day.
    """
    u = convert_units_to(ua, "m/s")
    w = _lanczos_lowpass_weights(61, 1 / 10)
    wl = len(w)
    half = wl // 2
    filt = weighted_window_sum(u.data, u.time_axis, w, half, half)
    lat_ax = u.dims.index("lat")
    lats = torch.as_tensor(np.asarray(u.coords["lat"], dtype=np.float32),
                           device=filt.device)
    # NaN -> -inf, then the first maximum: the reference's nanargmax
    strength = torch.where(torch.isnan(filt), -torch.inf, filt).amax(dim=lat_ax)
    arg = torch.nan_to_num(filt, nan=-torch.inf).argmax(dim=lat_ax)
    latitude = lats[arg]
    allnan = torch.isnan(filt).all(dim=lat_ax)
    strength = torch.where(allnan, torch.nan, strength)
    latitude = torch.where(allnan, torch.nan, latitude)
    out_dims = tuple(d for d in u.dims if d != "lat")
    coords = {c: v for c, v in u.coords.items() if c != "lat"}
    s = ClimArray(strength, out_dims, coords, {"units": "m s-1"}, "jetstream_strength")
    la = ClimArray(latitude, out_dims, dict(coords), {"units": "degrees_north"},
                   "jetstream_latitude")
    # reference returns (jetlat, jetstr) in that order (xclim:_synoptic.py:100)
    return la, s
