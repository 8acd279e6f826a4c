"""Missing-value methods: per-period masks applied after compute
(reference: xclim:src/xclim/core/missing.py).

The expected step counts per period come from the host-side calendar engine
(static tables); the valid-count reductions run on the data's device through
the segment engine. Periods marked True are masked (set NaN) by the indicator
layer.
"""

from __future__ import annotations

import numpy as np
import torch

from xclim_tpu_torch.core.calendar import (
    compare_offsets,
    date_range,
    parse_offset,
    resample_segments,
    select_time_mask,
)
from xclim_tpu_torch.core.dataarray import ClimArray
from xclim_tpu_torch.core.options import (
    CHECK_MISSING,
    MISSING_OPTIONS,
    OPTIONS,
    register_missing_method,
)
from xclim_tpu_torch.ops.runlength import longest_run
from xclim_tpu_torch.ops.segments import segment_reduce

__all__ = [
    "MissingAny",
    "MissingBase",
    "MissingPct",
    "MissingTwoSteps",
    "MissingWMO",
    "MissingSomeButNotAll",
    "AtLeastNValid",
    "expected_count",
    "at_least_n_valid",
    "missing_any",
    "missing_pct",
    "missing_wmo",
]


def expected_count(time, freq: str | None = None, src_timestep: str | None = None,
                   **indexer) -> np.ndarray:
    """Expected number of steps per resample period covered by `time`
    (xclim:core/missing.py:64). Host-side, from pure calendar math."""
    if src_timestep is None:
        src_timestep = time.infer_freq()
        if src_timestep is None:
            raise ValueError("src_timestep must be given when it can't be inferred.")
    if freq is None:
        # full range: generate the full period and count indexer steps
        full = date_range(time.isoformat(0), end=time.isoformat(len(time) - 1),
                          freq=src_timestep, calendar=time.calendar)
        mask = select_time_mask(full, **{k: v for k, v in indexer.items() if v is not None})
        return np.array(int(mask.sum()))
    spec = resample_segments(time, freq)
    if not any(v is not None for v in indexer.values()):
        # no time subsetting: the segment spec's calendar math is exact
        return spec.expected.astype(np.int64)
    # build the complete timeline covering all periods, at src_timestep.
    # For end-labeled freqs (ME/YE/QE) the label is the period's LAST step,
    # so the timeline must start expected[0]-1 steps earlier — starting at
    # the label would make the first period one step long.
    labels = spec.labels
    start_iso = labels.isoformat(0)
    _, _, is_start_freq, _ = parse_offset(freq)
    total = int(spec.expected.sum()) + 400
    if not is_start_freq:
        from xclim_tpu_torch.core.calendar import ordinal_to_date

        step_s = int(np.diff(time.encode()).min()) if len(time) > 1 else 86400
        enc0 = int(labels.encode()[0]) - (int(spec.expected[0]) - 1) * step_s
        yy, mm, dd = ordinal_to_date(np.array([enc0 // 86400]), time.calendar)
        sod = enc0 % 86400
        start_iso = (f"{int(yy[0]):04d}-{int(mm[0]):02d}-{int(dd[0]):02d} "
                     f"{sod // 3600:02d}:{(sod % 3600) // 60:02d}:{sod % 60:02d}")
    full = date_range(start_iso, periods=total, freq=src_timestep, calendar=time.calendar)
    fspec = resample_segments(full, freq)
    mask = select_time_mask(full, **{k: v for k, v in indexer.items() if v is not None})
    cnt = np.bincount(fspec.seg_id, weights=mask.astype(np.float64),
                      minlength=fspec.nseg).astype(np.int64)
    # align: match our labels to fspec labels by encoded start
    enc_l = labels.encode()
    enc_f = fspec.labels.encode()
    pos = np.searchsorted(enc_f, enc_l)
    pos = np.clip(pos, 0, len(enc_f) - 1)
    return cnt[pos]


class MissingBase:
    """Base missing-method: valid = non-NaN steps after indexing
    (xclim:core/missing.py:163)."""

    def __init__(self, **options):
        self.options = options

    @staticmethod
    def validate(**options):
        return True

    def _valid_mask(self, da: ClimArray, **indexer):
        valid = ~torch.isnan(da.data) if da.data.is_floating_point() \
            else torch.ones(da.shape, dtype=torch.bool, device=da.data.device)
        sel = select_time_mask(da.time, **{k: v for k, v in indexer.items() if v is not None})
        ax = da.time_axis
        if not sel.all():
            shape = [1] * da.ndim
            shape[ax] = len(sel)
            valid = valid & torch.as_tensor(
                sel, device=valid.device).reshape(shape)
        return valid, ax

    def is_missing(self, valid, count, spec, ax):
        raise NotImplementedError

    def __call__(self, da: ClimArray, freq: str | None = None,
                 src_timestep: str | None = None, **indexer) -> ClimArray:
        if src_timestep is None:
            src_timestep = da.time.infer_freq() or "D"
        valid, ax = self._valid_mask(da, **indexer)
        count = expected_count(da.time, freq, src_timestep, **indexer)
        spec = None if freq is None else resample_segments(da.time, freq)
        miss = self.is_missing(valid, count, spec, ax)
        if spec is None:
            out_dims = tuple(d for d in da.dims if d != "time")
            coords = {k: v for k, v in da.coords.items() if k != "time"}
            return ClimArray(miss, out_dims, coords, {}, da.name)
        coords = dict(da.coords)
        coords["time"] = spec.labels
        return ClimArray(miss, da.dims, coords, {}, da.name)

    def _nvalid(self, valid, spec, ax):
        v = valid.to(torch.float32)
        if spec is None:
            return v.sum(dim=ax)
        # the 0/1 mask holds no NaN and no segment is empty, so the
        # NaN-skipping sum is the reference's skipna=False sum, and on a
        # CUDA tensor it goes through the segred kernel
        return segment_reduce(v, spec, "sum", axis=ax)

    def _count_arr(self, count, spec, ax, ndim, device):
        c = torch.as_tensor(np.asarray(count, dtype=np.float32),
                            device=device)
        if spec is not None and c.ndim == 1:
            shape = [1] * ndim
            shape[ax] = spec.nseg
            c = c.reshape(shape)
        return c


@register_missing_method("any")
class MissingAny(MissingBase):
    """Period invalid if any expected step is missing (xclim:core/missing.py:311)."""

    def is_missing(self, valid, count, spec, ax):
        nvalid = self._nvalid(valid, spec, ax)
        return nvalid != self._count_arr(count, spec, ax, valid.ndim,
                                         valid.device)


class MissingTwoSteps(MissingBase):
    """Two-step mask: compute the method's mask at a finer ``subfreq``
    resolution, then merge the sub-periods into the target ``freq`` with
    the "any" rule — a period is invalid if any of its sub-periods is
    invalid, or if an expected sub-period is absent from the data
    (xclim:core/missing.py:338).

    ``subfreq=None`` in the options means a single resampling at the
    target frequency (plain :class:`MissingBase` behavior).
    """

    def __call__(self, da: ClimArray, freq: str | None = None,
                 src_timestep: str | None = None, **indexer) -> ClimArray:
        subfreq = self.options.get("subfreq") or freq
        if subfreq is not None and freq is not None \
                and compare_offsets(freq, "<", subfreq):
            raise ValueError(
                "The target resampling frequency cannot be finer than the "
                f"first-step frequency. Got : {subfreq} > {freq}.")
        miss = MissingBase.__call__(self, da, freq=subfreq,
                                    src_timestep=src_timestep, **indexer)
        if subfreq == freq:
            return miss
        # merge: invalid sub-periods become NaN so MissingAny flags both
        # any-invalid and incomplete sub-period coverage of the target period
        sub = miss.copy(data=torch.where(miss.data, torch.nan, 0.0))
        sub.attrs = {}
        return MissingAny()(sub, freq, src_timestep=subfreq, **indexer)


@register_missing_method("wmo")
class MissingWMO(MissingTwoSteps):
    """WMO criteria at monthly scale: ≥nm missing or ≥nc consecutive missing
    days in any month of the period (xclim:core/missing.py:395)."""

    def __init__(self, nm: int = 11, nc: int = 5):
        super().__init__(nm=nm, nc=nc, subfreq="MS")

    @staticmethod
    def validate(nm: int = 11, nc: int = 5, **kw):
        return nm < 31 and nc < 31

    def is_missing(self, valid, count, spec, ax):
        nvalid = self._nvalid(valid, spec, ax)
        missing_days = self._count_arr(count, spec, ax, valid.ndim,
                                       valid.device) - nvalid
        cond1 = missing_days >= self.options["nm"]
        longest = longest_run(~valid, axis=ax, spec=spec)
        cond2 = longest >= self.options["nc"]
        return cond1 | cond2


@register_missing_method("pct")
class MissingPct(MissingTwoSteps):
    """Period invalid when missing fraction ≥ tolerance (xclim:core/missing.py:454)."""

    def __init__(self, tolerance: float = 0.1, subfreq: str | None = None):
        super().__init__(tolerance=tolerance, subfreq=subfreq)

    @staticmethod
    def validate(tolerance: float = 0.1, **kw):
        return 0 <= tolerance <= 1

    def is_missing(self, valid, count, spec, ax):
        nvalid = self._nvalid(valid, spec, ax)
        c = self._count_arr(count, spec, ax, valid.ndim, valid.device)
        missing_days = c - nvalid
        return (missing_days / c) >= self.options["tolerance"]


@register_missing_method("at_least_n")
class AtLeastNValid(MissingTwoSteps):
    """Period invalid with fewer than n valid values (xclim:core/missing.py:486)."""

    def __init__(self, n: int = 20, subfreq: str | None = None):
        super().__init__(n=n, subfreq=subfreq)

    @staticmethod
    def validate(n: int = 20, **kw):
        return n > 0

    def is_missing(self, valid, count, spec, ax):
        nvalid = self._nvalid(valid, spec, ax)
        return nvalid < self.options["n"]


# --- shortcut functions (xclim:core/missing.py:525+) ---


def missing_any(da: ClimArray, freq: str | None = None, src_timestep=None, **indexer):
    return MissingAny()(da, freq, src_timestep, **indexer)


def missing_wmo(da: ClimArray, freq: str | None = None, src_timestep=None,
                nm: int = 11, nc: int = 5, **indexer):
    return MissingWMO(nm=nm, nc=nc)(da, freq, src_timestep, **indexer)


def missing_pct(da: ClimArray, freq: str | None = None, src_timestep=None,
                tolerance: float = 0.1, **indexer):
    return MissingPct(tolerance=tolerance)(da, freq, src_timestep, **indexer)


def at_least_n_valid(da: ClimArray, freq: str | None = None, src_timestep=None,
                     n: int = 20, **indexer):
    return AtLeastNValid(n=n)(da, freq, src_timestep, **indexer)


@register_missing_method("some_but_not_all")
class MissingSomeButNotAll(MissingBase):
    """Period invalid if some but not all of its steps are missing
    (xclim:core/missing.py:326)."""

    def is_missing(self, valid, count, spec, ax):
        nvalid = self._nvalid(valid, spec, ax)
        c = self._count_arr(count, spec, ax, valid.ndim, valid.device)
        return ~((nvalid == c) | (nvalid == 0))


def missing_some_but_not_all(da: ClimArray, freq: str | None = None,
                             src_timestep=None, **indexer):
    return MissingSomeButNotAll()(da, freq, src_timestep, **indexer)


def missing_from_context(da: ClimArray, freq: str | None = None,
                         src_timestep=None, **indexer):
    """Mask periods missing according to the globally configured method
    (OPTIONS['check_missing']; xclim:core/missing.py)."""
    from xclim_tpu_torch.core.options import (CHECK_MISSING, MISSING_METHODS,
                                        MISSING_OPTIONS, OPTIONS)

    method = OPTIONS[CHECK_MISSING]
    cls = MISSING_METHODS[method]
    opts = OPTIONS[MISSING_OPTIONS].get(method, {})
    return cls(**opts)(da, freq, src_timestep, **indexer)
