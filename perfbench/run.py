"""Entry point of the benchmark of temfpy_torch (see ``harness.py``).

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>
"""

import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]

import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(t_start=T_START))
