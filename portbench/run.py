"""Run one benchmark cell once:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Prints the result as the last line of standard output (see
harness/bench.py). Exits non-zero, printing no result, without the
CUDA devices the cell asks for."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from portbench.harness import bench  # noqa: E402

if __name__ == "__main__":
    sys.exit(bench.main())
