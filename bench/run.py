"""The port's benchmark: one cell of ``BENCHMARK.json``, measured and checked.

    python3 bench/run.py --workload resnet20.fig2b.k4 --seed 7 --seconds 10 --trace 0
    python3 bench/run.py --workload resnet20.fig2b.k4 --seed 7 --seconds 2 --trace 0 --rehearse

Run from the root of a checkout that holds the port under ``src/``; see
``benchlib/driver.py`` for what a run does and prints.
"""

import time

T_START = time.perf_counter()

import pathlib  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))

from benchlib.driver import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
