"""The benchmark of ``xclim_tpu_torch`` on an NVIDIA GPU.

``BENCHMARK.json`` at the repo's root names the cells; ``python3 -m
perfbench --workload <name> --seed <n> --seconds <s> --trace <0|1>`` runs
one (:mod:`perfbench.run`). Configurations are ``configs/*.json``, traffic
mixes ``traffic/*.json``, metric readers ``metrics/<metric>.py``, the
callers of the program's entries ``callers/``, and the plain references
that decide ``correct`` ``reference/`` (which import nothing of the
program). ``python3 -m perfbench.control`` runs a cell's lower-precision
control.
"""
