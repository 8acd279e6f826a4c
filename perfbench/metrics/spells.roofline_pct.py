"""spells.roofline_pct: the least time of the window's calls of the op entry
``xclim_tpu_torch.ops.spells.spell_stats`` over their device time (CUDA
events around each call), in percent.

The work is read from each call's arguments, whatever implements the
entry: the series or condition ``x`` read once (float32 or one byte a day)
and its four (segments) counts written once, each of x's shape with the
time axis replaced by the segments; operations, a few a day read (the
compare and the run's counts), which stay far under the bytes. Nothing to
read when the entry was not called.
"""

from perfbench import roofline

ENTRY = "xclim_tpu_torch.ops.spells:spell_stats"


def work(args, kwargs, out):
    x = args[0]
    return roofline.tensor_bytes(x, *out), 4.0 * x.numel()


def read(run):
    return roofline.share(run.entries.get(ENTRY))
