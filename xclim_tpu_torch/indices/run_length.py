"""Public run-length API on ClimArrays (reference: xclim:src/xclim/indices/run_length.py).

Thin host-side layer over :mod:`xclim_tpu_torch.ops.runlength`: builds the
segment spec from the time coordinate and wraps device results with the
right labels. Ported so far: the run statistics over resample periods; the
date- and season-based functions and ``find_events`` wait for the spells
slice.
"""

from __future__ import annotations

from xclim_tpu_torch.core.calendar import SegmentSpec, resample_segments
from xclim_tpu_torch.core.dataarray import ClimArray
from xclim_tpu_torch.ops import runlength as _rl

__all__ = [
    "cumsum_reset",
    "rle",
    "rle_statistics",
    "statistics_run",
    "longest_run",
    "windowed_run_count",
    "windowed_run_events",
    "windowed_max_run_sum",
]


def _spec(da: ClimArray, freq: str | None) -> SegmentSpec | None:
    return None if freq is None else resample_segments(da.time, freq)


def _wrap_seg(da: ClimArray, data, spec: SegmentSpec | None, units: str = ""):
    if spec is None:
        out_dims = tuple(d for d in da.dims if d != "time")
        coords = {k: v for k, v in da.coords.items() if k != "time"}
        return ClimArray(data, out_dims, coords, {"units": units}, da.name)
    coords = dict(da.coords)
    coords["time"] = spec.labels
    return ClimArray(data, da.dims, coords, {"units": units}, da.name)


def cumsum_reset(da: ClimArray, index: str = "last",
                 reset_on_zero: bool = True) -> ClimArray:
    out = _rl.cumsum_reset(da.data, axis=da.time_axis, index=index,
                           reset_on_zero=reset_on_zero)
    return da.copy(data=out)


def rle(da: ClimArray, index: str = "first") -> ClimArray:
    return da.copy(data=_rl.rle(da.data, axis=da.time_axis, index=index))


def rle_statistics(da: ClimArray, reducer: str, window: int, freq: str | None = None,
                   index: str = "first", resample_before_rl: bool = True) -> ClimArray:
    spec = _spec(da, freq)
    out = _rl.rle_statistics(da.data, reducer, window, axis=da.time_axis, spec=spec,
                             index=index, resample_before_rl=resample_before_rl)
    return _wrap_seg(da, out, spec)


statistics_run = rle_statistics


def longest_run(da: ClimArray, freq: str | None = None, index: str = "first",
                resample_before_rl: bool = True) -> ClimArray:
    return rle_statistics(da, "max", 1, freq=freq, index=index,
                          resample_before_rl=resample_before_rl)


def windowed_run_count(da: ClimArray, window: int, freq: str | None = None,
                       resample_before_rl: bool = True,
                       index: str = "first") -> ClimArray:
    # `index` picks which end of the run carries the rle value: the totals
    # are identical either way (the reference parameterizes both to prove it)
    spec = _spec(da, freq)
    out = _rl.windowed_run_count(da.data, window, axis=da.time_axis, spec=spec,
                                 resample_before_rl=resample_before_rl)
    return _wrap_seg(da, out, spec)


def windowed_run_events(da: ClimArray, window: int, freq: str | None = None,
                        resample_before_rl: bool = True,
                        index: str = "first") -> ClimArray:
    spec = _spec(da, freq)
    out = _rl.windowed_run_events(da.data, window, axis=da.time_axis, spec=spec,
                                  resample_before_rl=resample_before_rl)
    return _wrap_seg(da, out, spec)


def windowed_max_run_sum(da: ClimArray, window: int, freq: str | None = None,
                         resample_before_rl: bool = True,
                         index: str = "first") -> ClimArray:
    spec = _spec(da, freq)
    out = _rl.windowed_max_run_sum(da.data, window, axis=da.time_axis, spec=spec,
                                   resample_before_rl=resample_before_rl)
    return _wrap_seg(da, out, spec)
