"""Density-based outlier detection on the radius op (paper §4.3 use case).

Counterpart of ``examples/outlier_detection.py``: finds outliers in a
synthetic sky catalog by counting neighbors inside a fixed radius: points
whose neighborhood is near-empty are the anomalies.  ``IndexSpec(op=
"radius")`` makes the planner pick a dual-tree-capable engine, ``warm``
runs the op once ahead, and ``index.radius`` returns the CSR neighborhoods
whose row lengths ARE the density scores.

    PYTHONPATH=src python -m repro_torch.examples.outlier_detection [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.api import IndexSpec, KNNIndex

N_ANOM = 25


def catalog(n: int, d: int = 3) -> np.ndarray:
    """Clustered sources (uniform balls around 64 centers on a patch: every
    member has a dense r-ball) and ``N_ANOM`` planted sparse anomalies far
    off every cluster, appended last."""
    rng = np.random.default_rng(1)
    centers = rng.uniform(0.0, 1.0, size=(64, d)).astype(np.float32)
    u = rng.normal(size=(n, d)).astype(np.float32)
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    radial = 0.03 * rng.random(n).astype(np.float32) ** (1.0 / d)
    cat = centers[rng.integers(0, len(centers), n)] + u * radial[:, None]
    anomalies = rng.uniform(2.0, 3.0, size=(N_ANOM, d)).astype(np.float32)
    return np.concatenate([cat, anomalies]).astype(np.float32)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--n", type=int, default=60_000)
    ap.add_argument("--height", type=int, default=8)
    args = ap.parse_args(argv)
    dev = torch.device("cuda", 0) if args.device == "cuda" else torch.device("cpu")
    n = args.n
    data = catalog(n)

    # height pinned dual-tree-friendly: small leaves keep the leaf pairs
    # narrow (the kNN cost model would pick far fewer, fatter leaves)
    t0 = time.time()
    index = KNNIndex.build(data, IndexSpec(op="radius", height=args.height, m_hint=len(data),
                                           devices=(dev,)))
    t_build = time.time() - t0
    print(index.describe())

    r = 0.02  # neighborhood radius (about one cluster core width)
    index.warm(m=len(data), ops=("radius",))

    # all-source neighborhoods in one dual-tree pass: density = row length
    t0 = time.time()
    indptr, ids, dists = index.radius(data, r)
    t_radius = time.time() - t0

    counts = np.diff(indptr) - 1  # minus the source itself (dist 0 <= r)
    rank = np.argsort(counts, kind="stable")
    flagged = set(rank[:N_ANOM].tolist())
    planted = set(range(n, n + N_ANOM))

    print(f"n={len(data)} build={t_build:.2f}s radius={t_radius:.2f}s "
          f"({len(data) / t_radius:.0f} src/s) r={r}")
    print(f"median neighbors: {int(np.median(counts))}  "
          f"leaf pairs visited: {index.stats.units_scanned}")
    print(f"planted outliers recovered in bottom-{N_ANOM} density: "
          f"{len(flagged & planted)}/{N_ANOM}")
    assert len(flagged & planted) == N_ANOM  # isolated sources have ~0 neighbors
    assert counts[list(planted)].max() < counts[:n].min()  # clean separation
    return {"counts": counts, "flagged": flagged, "indptr": indptr, "ids": ids,
            "dists": dists}


if __name__ == "__main__":
    main()
