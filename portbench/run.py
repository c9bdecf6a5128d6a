r"""Run one cell of the port's benchmark once, from the root of a checkout:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is the result (JSON); see
``portbench/README.md``.
"""

import os
import sys
import time

T_START = time.monotonic()      # set-up is timed from here

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from portbench.harness import main

    sys.exit(main(t_start=T_START))
