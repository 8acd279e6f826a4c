"""Indicator realm modules (reference: xclim:src/xclim/indicators/)."""

from xclim_tpu_torch.indicators import atmos, convert, generic, land, seaIce  # noqa: F401
