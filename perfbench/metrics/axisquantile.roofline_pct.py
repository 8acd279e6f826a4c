"""axisquantile.roofline_pct: the least time of the window's calls of the op
entry ``xclim_tpu_torch.ops.axisquantile.axis_quantile_small`` over their
device time (CUDA events around each call), in percent.

The work is read from each call's arguments, whatever implements the
entry: the samples ``x`` read once and the quantiles written once;
operations, the interpolation's 4 a quantile, which stay far under the
bytes. Nothing to read when the entry was not called.
"""

from perfbench import roofline

ENTRY = "xclim_tpu_torch.ops.axisquantile:axis_quantile_small"


def work(args, kwargs, out):
    return roofline.tensor_bytes(args[0], out), 4.0 * out.numel()


def read(run):
    return roofline.share(run.entries.get(ENTRY))
