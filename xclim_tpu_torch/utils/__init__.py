"""Runtime utilities: profiling/tracing (the reference's observability is
the dask dashboard; here it is ``torch.profiler`` traces)."""

from xclim_tpu_torch.utils.profiling import profile, timed  # noqa: F401
