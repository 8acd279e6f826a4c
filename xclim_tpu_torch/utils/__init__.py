"""Runtime utilities: profiling/tracing (the reference's observability is
the dask dashboard; here it is ``torch.profiler`` traces and the program's
own spans)."""

from xclim_tpu_torch.utils.profiling import profile, span, timed, tracing  # noqa: F401
