"""Run one cell of the benchmark of the PyTorch + CUDA port once.

    python3 bench_h100/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The last line of standard output is the
result (JSON); the compared numbers and their limits close standard error.
The run needs as many CUDA devices as the cell's ``chips`` and exits with
another code than 0, printing no result, without them.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
# The port's kernels build into its own folder inside this checkout; a
# Triton cache, should anything use one, stays inside it too.
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "bench_h100" / "_cache" / "triton")

from bench_h100 import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(harness.parse_args(), T_START))
