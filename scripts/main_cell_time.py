"""Time chip_smoke.py's main cell (or its wide cell) alone, with none of its earlier phases.

Run from the root of a tree of this repository (on a CUDA machine):

    python3 scripts/main_cell_time.py --shift 2 --repeats 3
    python3 scripts/main_cell_time.py --d 30 --shift 2    # the wide cell's rows

It builds the index of the main cell (a seeded 64-component Gaussian
mixture, the same points as ``chip_smoke.main_data``, made here so that
the script runs from any tree's root: d = 10 or ``--d``, n = 2**(24 -
shift) points, m = 2**(20 - shift) queries; planner defaults) with the
tree's own ``repro_torch``, then answers the queries ``--repeats`` times,
printing build_s, each query_s, the rounds and the leaf-scan launches.
Run it from two trees' roots in one call, alternated (A, B, B, A), to
compare their path without the rest of chip_smoke.py; a newer tree's copy
may be run from an older tree's root.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time


def mixture_data(seed: int, shift: int, d: int):
    """n = 2**(24 - shift) points and m = 2**(20 - shift) queries of width
    d from a seeded 64-component Gaussian mixture (``chip_smoke.main_data``'s
    points at the same seed, shift and d)."""
    import numpy as np

    n, m = 2 ** (24 - shift), 2 ** (20 - shift)
    rng = np.random.default_rng(seed)
    centers = rng.normal(scale=3.0, size=(64, d)).astype(np.float32)
    scales = rng.uniform(0.3, 1.5, size=64).astype(np.float32)

    def draw(count):
        lab = rng.integers(0, 64, size=count)
        pts = rng.standard_normal(size=(count, d), dtype=np.float32)
        pts *= scales[lab, None]
        pts += centers[lab]
        return pts

    points = draw(n)
    return points, draw(m)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--shift", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--d", type=int, default=10, help="features per point (wide cell: 30)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("main_cell_time: no CUDA device is available", file=sys.stderr)
        return 1
    root = os.getcwd()
    sys.path.insert(0, os.path.join(root, "src"))
    from repro_torch.api import KNNIndex
    from repro_torch.kernels import knn_scan

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    points, queries = mixture_data(args.seed, args.shift, args.d)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    index = KNNIndex.build(points, None)
    torch.cuda.synchronize()
    print(f"[main_cell] tree={root} n={points.shape[0]} m={queries.shape[0]} d={args.d} "
          f"engine={index.plan.engine} n_chunks={index.plan.n_chunks} "
          f"build_s={time.perf_counter() - t0:.3f}", flush=True)
    for r in range(args.repeats):
        knn_scan.reset_launches()
        t0 = time.perf_counter()
        res = index.query(queries, 10)
        query_s = time.perf_counter() - t0
        st = res.stats
        print(f"[main_cell] repeat={r} query_s={query_s:.3f} rounds={st.iterations} "
              f"units={st.units_scanned} tail_s={st.tail_s:.3f} "
              f"launches={knn_scan.leaf_scan_units.launches} "
              f"fp32_launches={knn_scan.leaf_scan_units.launches_by_code['f32']}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
