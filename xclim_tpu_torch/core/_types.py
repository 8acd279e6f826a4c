"""Shared type aliases and the official variable vocabulary
(reference: xclim:src/xclim/core/_types.py, 46 LoC)."""

from __future__ import annotations

from xclim_tpu_torch.core.variables import VARIABLES  # noqa: F401

__all__ = ["DateStr", "DayOfYearStr", "Quantified", "VARIABLES"]

#: ISO date string ('YYYY-MM-DD...')
DateStr = str

#: 'MM-DD' day-of-year string
DayOfYearStr = str

#: A quantity: magnitude with units — a quantified string ("5 mm/d"),
#: a Quantity, or a ClimArray with a units attribute
Quantified = object
