"""Run one cell of the benchmark once and print its result line.

    python3 kdbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, ``kdbench/``
and the program under ``src/``.  The last line of standard output is the
result's JSON object; the compared numbers and their limits are the last
lines of standard error.  Exits non-zero, with no result, without the
cards the cell asks for or where a forbidden module was loaded.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

# compile caches at fixed paths inside the checkout (build/ is not
# committed), so that only a checkout's first run fills them; the kernel
# library is built into build/kernels/ by the program itself
CACHES = {
    "TRITON_CACHE_DIR": ROOT / "build" / "triton",
    "TORCH_EXTENSIONS_DIR": ROOT / "build" / "torch_extensions",
    "CUDA_CACHE_PATH": ROOT / "build" / "cuda_cache",
}

if __name__ == "__main__":
    for key, path in CACHES.items():
        os.environ[key] = str(path)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from kdbench.harness import main

    sys.exit(main(root=ROOT, t_start=T_START))
