#!/usr/bin/env python3
"""Run one cell of the benchmark once, on the card:

    python3 port_bench/run.py --workload <cell> --seed <n> \
        --seconds <s> --trace <0|1>

from the root of a checkout. Prints the result as the last line of its
standard output (``harness.run_cell``) and each number the comparison
read beside its limit as the last lines of its standard error. Without a
CUDA device it exits non-zero and prints no result.
"""

import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# One process with few host threads; caches inside the checkout.
os.environ.setdefault("OMP_NUM_THREADS", "4")
os.environ["USE_FLAX"] = "0"
os.environ["CUDA_CACHE_PATH"] = os.path.join(ROOT, "build", "port_bench",
                                             "cuda_cache")
sys.path.insert(0, ROOT)

from port_bench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T0))
