"""Run one cell of the benchmark once; see ``bench/harness.py``.

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  Puts the checkout's root (for ``bench``) and
``src/`` (for the program, ``repro_torch``) on the import path, then hands
over to :func:`bench.harness.main`.  Prints the result as the last line of
standard output; exits non-zero, printing no result, without the CUDA
devices the cell asks for.
"""
import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# the checkout's root and src/ in place of this script's folder
sys.path[0:1] = [str(ROOT), str(ROOT / "src")]

from bench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T_START))
