"""Synthetic test-data generators (reference: xclim:src/xclim/testing/helpers.py).

The values are made with numpy on the host, as the JAX package makes them
(the same seed gives the same values), and go to ``device`` (default:
:func:`xclim_tpu_torch.default_device`).
"""

from __future__ import annotations

import numpy as np

from xclim_tpu_torch.core.calendar import date_range
from xclim_tpu_torch.core.dataarray import ClimArray, ClimDataset
from xclim_tpu_torch.core.variables import VARIABLES

__all__ = ["test_timeseries", "generate_atmos", "test_grid"]

# keep pytest from collecting the helpers as tests
__test__ = False


def test_timeseries(
    values,
    variable: str = "tas",
    start: str = "2000-07-01",
    freq: str = "D",
    units: str | None = None,
    calendar: str = "standard",
    as_dataset: bool = False,
    device=None,
):
    """Build a 1-D ClimArray with correct CF attrs from the variable vocabulary
    (xclim:src/xclim/testing/helpers.py:163-217)."""
    values = np.asarray(values)
    time = date_range(start, periods=len(values), freq=freq, calendar=calendar)
    meta = VARIABLES.get(variable, {})
    attrs = {
        "units": units if units is not None else meta.get("canonical_units", ""),
    }
    if meta.get("standard_name"):
        attrs["standard_name"] = meta["standard_name"]
    if meta.get("cell_methods"):
        attrs["cell_methods"] = meta["cell_methods"]
    if values.dtype.kind in "fi":
        values = values.astype(np.float32)
    da = ClimArray(values, dims=("time",), coords={"time": time}, attrs=attrs,
                   name=variable, device=device)
    if as_dataset:
        return ClimDataset({variable: da})
    return da


def test_grid(values, variable: str = "tas", start: str = "2000-01-01", freq: str = "D",
              units: str | None = None, calendar: str = "standard", device=None):
    """(T, Y, X) grid ClimArray from a 3-D numpy array."""
    values = np.asarray(values, dtype=np.float32)
    T, Y, X = values.shape
    time = date_range(start, periods=T, freq=freq, calendar=calendar)
    meta = VARIABLES.get(variable, {})
    attrs = {"units": units if units is not None else meta.get("canonical_units", "")}
    if meta.get("standard_name"):
        attrs["standard_name"] = meta["standard_name"]
    return ClimArray(values, dims=("time", "lat", "lon"),
                     coords={"time": time,
                             "lat": np.linspace(-60, 60, Y),
                             "lon": np.linspace(0, 360, X, endpoint=False)},
                     attrs=attrs, name=variable, device=device)


def generate_atmos(seed: int = 0, nyears: int = 4, calendar: str = "standard",
                   device=None) -> ClimDataset:
    """Small synthetic multivariate daily dataset (tas/tasmax/tasmin/pr)
    — stand-in for the reference's atmosds fixture (testing/helpers.py:35-79)."""
    rng = np.random.default_rng(seed)
    time = date_range("2000-01-01", end=f"{2000 + nyears - 1}-12-31", freq="D", calendar=calendar)
    n = len(time)
    doy = time.doy
    seasonal = 10 * np.cos(2 * np.pi * (doy - 200) / 365.25)
    tas = 283.15 + seasonal + rng.normal(0, 3, n)
    dtr = 5 + rng.normal(0, 1, n).clip(-3, 3)
    tasmax = tas + dtr / 2
    tasmin = tas - dtr / 2
    pr = rng.gamma(0.9, 4e-5, n) * (rng.random(n) < 0.35)

    def mk(name, vals):
        meta = VARIABLES[name]
        return ClimArray(np.asarray(vals, dtype=np.float32), ("time",),
                         {"time": time},
                         {"units": meta["canonical_units"],
                          "standard_name": meta["standard_name"],
                          "cell_methods": meta["cell_methods"]}, name,
                         device=device)

    return ClimDataset({
        "tas": mk("tas", tas),
        "tasmax": mk("tasmax", tasmax),
        "tasmin": mk("tasmin", tasmin),
        "pr": mk("pr", pr),
    })


test_timeseries.__test__ = False  # noqa: E305  — pytest: not a test
test_grid.__test__ = False


class _LazinessGuard:
    """Context manager asserting that no data leave the card inside the
    block (the reference's `assert_lazy` guards against dask compute:
    xclim:src/xclim/testing/helpers.py:220-238). Here a torch dispatch mode
    raises at any copy from a CUDA tensor to the host, ``.item()``
    included. On CPU tensors host and device memory are one and the guard
    never fires; it is effective on the card, where accidental transfers
    cost."""

    def __enter__(self):
        import torch
        from torch.utils._python_dispatch import TorchDispatchMode

        aten = torch.ops.aten
        copies = {aten._to_copy.default, aten.copy_.default}

        def on_card(x):
            return isinstance(x, torch.Tensor) and x.is_cuda

        class NoDeviceToHost(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                if func is aten._local_scalar_dense.default and on_card(args[0]):
                    raise RuntimeError("assert_lazy: a value was read back "
                                       "from the card (.item())")
                out = func(*args, **kwargs)
                if func in copies and isinstance(out, torch.Tensor) \
                        and not out.is_cuda and any(on_card(a) for a in args):
                    raise RuntimeError("assert_lazy: data were copied from "
                                       "the card to the host")
                return out

        self._mode = NoDeviceToHost()
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        return self._mode.__exit__(*exc)


assert_lazy = _LazinessGuard()
