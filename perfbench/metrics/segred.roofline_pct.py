"""segred.roofline_pct: the least time of the window's calls of the op entry
``xclim_tpu_torch.ops.segred.segment_reduce_onepass`` over their device
time (CUDA events around each call), in percent.

The work is read from each call's arguments, whatever implements the
entry: the (days, cells) series ``x2`` read once and the (segments, cells)
result written once; operations, one a value read (the sum or the compare
that keeps a minimum or maximum; two for var and std), which stay far
under the bytes. Nothing to read when the entry was not called.
"""

from perfbench import roofline

ENTRY = "xclim_tpu_torch.ops.segred:segment_reduce_onepass"


def work(args, kwargs, out):
    x2 = args[0]
    op = args[3] if len(args) > 3 else kwargs["op"]
    return (roofline.tensor_bytes(x2, out),
            float(x2.numel() * (2 if op in ("var", "std") else 1)))


def read(run):
    return roofline.share(run.entries.get(ENTRY))
