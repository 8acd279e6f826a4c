"""qdmadjust.roofline_pct: the least time of the window's calls of the op
entry ``xclim_tpu_torch.ops.qdmadjust.qdm_adjust_series`` over their device
time (CUDA events around each call), in percent.

The work is read from each call's arguments, whatever implements the
entry: the series ``xf2`` (days, cells), its group table and the factors
``af`` (n_doy, nodes, cells) read once, the adjusted series written once;
operations, each value's rank among its group's (slots^2 compares a group
and cell), which stay far under the bytes. Nothing to read when the entry
was not called.
"""

from perfbench import roofline

ENTRY = "xclim_tpu_torch.ops.qdmadjust:qdm_adjust_series"


def work(args, kwargs, out):
    xf2, table, af = args[:3]
    groups, slots = table.shape
    return (roofline.tensor_bytes(xf2, table, af, out),
            float(groups * slots * slots * xf2.shape[1]))


def read(run):
    return roofline.share(run.entries.get(ENTRY))
