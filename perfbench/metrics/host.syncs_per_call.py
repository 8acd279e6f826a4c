"""host.syncs_per_call: the host syncs a call that the program's spans
counted (``xclim_tpu_torch.utils.profiling``'s ``host_syncs``: torch's
sync debug mode warns on each synchronizing CUDA call, such as ``.item()``,
a boolean mask or a copy to or from pageable host memory), in the traced
run's second stretch (``perfbench/program.py``). Nothing to read where the
program has no tracing."""

from perfbench import program


def read(run):
    p = program.stretch(run)
    return p["host_syncs"] / p["calls"] if p else None
