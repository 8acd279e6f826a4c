"""Data conformance checks (reference: xclim:src/xclim/core/datachecks.py)."""

from __future__ import annotations

from xclim_tpu_torch.core._exceptions import ValidationError
from xclim_tpu_torch.core.calendar import parse_offset
from xclim_tpu_torch.core.options import datacheck

__all__ = ["check_common_time", "check_daily", "check_freq"]


@datacheck
def check_freq(var, freq: str | list[str], strict: bool = True):
    """Raise if the inferred frequency doesn't match `freq`
    (xclim:core/datachecks.py:20)."""
    if isinstance(freq, str):
        freq = [freq]
    exp_base = [parse_offset(f)[1] for f in freq]
    v_freq = var.time.infer_freq() if var.time is not None else None
    if v_freq is None:
        if strict:
            raise ValidationError(
                "Unable to infer the frequency of the time series. "
                "To mute this, set xclim_tpu_torch's option data_validation='log'.")
        return None
    try:
        v_base = parse_offset(v_freq)[1]
    except ValueError:
        # e.g. a decreasing index infers a negative step ('-12h')
        raise ValidationError(
            f"Frequency of time series not in {freq}. Got {v_freq}.") from None
    if v_freq not in freq and (strict or (v_base not in exp_base)):
        raise ValidationError(
            f"Frequency of time series not {'strictly' if strict else ''} in {freq}. "
            f"Got {v_freq}.")
    return None


@datacheck
def check_daily(var):
    """Raise if not daily (no gaps) (xclim:core/datachecks.py:59)."""
    if var.time is None or var.time.infer_freq() != "D":
        raise ValidationError("Time series is not daily.")
    return None


@datacheck
def check_common_time(inputs):
    """Check all inputs share the same frequency & alignment
    (xclim:core/datachecks.py:76)."""
    freqs = [i.time.infer_freq() for i in inputs if i.time is not None]
    if any(f is None for f in freqs):
        raise ValidationError("Unable to infer the frequency of the time series.")
    if len(set(freqs)) != 1:
        raise ValidationError(f"Inputs have different frequencies: {freqs}.")
    mult, base, _, _ = parse_offset(freqs[0])
    if base in "hms":
        sods = {int(i.time.seconds_of_day[0]) for i in inputs if i.time is not None}
        if len(sods) > 1:
            raise ValidationError(
                f"All inputs have the same frequency ({freqs[0]}), but they "
                "are not anchored on the same minutes. "
                "To mute this, set xclim_tpu_torch's option data_validation='log'.")
    return None
