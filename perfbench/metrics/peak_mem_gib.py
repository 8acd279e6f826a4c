"""peak_mem_gib: torch.cuda.max_memory_allocated() over the window (reset
at its start), inputs and trained state included. Nothing on a CPU run."""


def read(run):
    return run.peak_bytes / 2**30 if run.peak_bytes else None
