"""Run one cell of the benchmark once and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout on a machine with the CUDA devices the cell
asks for.  Without them it exits with code 3 and prints no result.  The
last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and the compared numbers under ``checks``); the compared
numbers are also the last lines of standard error.
"""

import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# every build and kernel cache at a fixed path inside the checkout; the
# port's own kernels build into build/kernels/ (``kernels/_build.py``)
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" /
                                                  "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
os.environ.setdefault("USE_FLAX", "0")
# load from one process with few threads: the host's share of a round or
# a step is launch work, and idle OpenMP or BLAS threads only add jitter
for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[var] = "1"
# this file's own folder would shadow the standard library's modules
sys.path[0:1] = [str(ROOT), str(ROOT / "src")]

from perfbench.core import main, process_start  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=process_start()))
