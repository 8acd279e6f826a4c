"""eqmadjust.roofline_pct: the least time of the window's calls of the op
entry ``xclim_tpu_torch.ops.eqmadjust.eqm_adjust_series`` over their device
time (CUDA events around each call), in percent.

The work is read from each call's arguments, whatever implements the
entry: the series ``xf2`` (days, cells), its group table and the trained
``hist_q`` and ``af`` (groups, nodes, cells) read once, the adjusted series
written once; operations, each value's compare with every node of its
group (days x cells x nodes), which stay under the bytes. Nothing to read
when the entry was not called, or where the program has no such entry (it
is then not wrapped).
"""

import importlib.util

from perfbench import roofline

_ENTRY = "xclim_tpu_torch.ops.eqmadjust:eqm_adjust_series"
if importlib.util.find_spec(_ENTRY.split(":")[0]) is not None:
    ENTRY = _ENTRY


def work(args, kwargs, out):
    xf2, table, hist_q, af = args[:4]
    return (roofline.tensor_bytes(xf2, table, hist_q, af, out),
            float(xf2.numel() * hist_q.shape[1]))


def read(run):
    return roofline.share(run.entries.get(_ENTRY))
