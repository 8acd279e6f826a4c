"""``python3 -m perfbench --workload <name> --seed <n> --seconds <s> --trace <0|1>``"""

import time

T_START = time.perf_counter()   # set-up is timed from here

import sys  # noqa: E402

from perfbench.run import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T_START))
