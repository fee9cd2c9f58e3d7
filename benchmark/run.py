"""Run one cell of the benchmark once (see ``harness/cli.py``).

    python3 benchmark/run.py --workload small.eval-long --seed 7 --seconds 20 --trace 0

Every cache the run writes stays inside the checkout, at fixed paths
(``harness/caches.py``).
"""

import os
import sys
import time


def _process_start() -> float:
    """The process's start on the wall clock (Linux), else now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - (uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.time()


STARTED = _process_start()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from benchmark.harness.caches import use_checkout_caches  # noqa: E402

use_checkout_caches(ROOT)

from benchmark.harness.cli import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], STARTED))
