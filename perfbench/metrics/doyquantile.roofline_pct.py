"""doyquantile.roofline_pct: the least time of the window's calls of the op
entry ``xclim_tpu_torch.ops.doyquantile.doy_quantile`` over their device
time (CUDA events around each call), in percent.

The work is read from each call's arguments, whatever implements the
entry: the (days, cells...) series and its (doys, samples) table read once,
the (quantiles, doys, cells...) thresholds written once; operations, the
interpolation's few a threshold, which stay far under the bytes. Nothing
to read when the entry was not called, or where the program has no such
entry (it is then not wrapped).
"""

import importlib.util

from perfbench import roofline

_ENTRY = "xclim_tpu_torch.ops.doyquantile:doy_quantile"
if importlib.util.find_spec(_ENTRY.split(":")[0]) is not None:
    ENTRY = _ENTRY


def work(args, kwargs, out):
    series, table = args[:2]
    return roofline.tensor_bytes(series, table, out), 4.0 * out.numel()


def read(run):
    return roofline.share(run.entries.get(_ENTRY))
