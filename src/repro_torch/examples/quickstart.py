"""Quickstart: one front door — ``KNNIndex.build(points).query(q, k)``.

Counterpart of ``examples/quickstart.py``.  The planner picks the
execution engine from data shape, device topology and memory budget; every
knob can also be pinned through ``IndexSpec``.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.api import IndexSpec, KNNIndex, available_engines, knn_brute
from repro_torch.data.pipeline import PointCloud


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--m", type=int, default=10_000)
    ap.add_argument("--height", type=int, default=7)
    args = ap.parse_args(argv)
    dev = torch.device("cuda", 0) if args.device == "cuda" else torch.device("cpu")
    spec = IndexSpec(height=args.height, devices=(dev,))

    # astronomy-like catalog: 100k points, d=10 (crts features)
    pc = PointCloud(args.n, 10, seed=0)
    points = pc.points()
    queries = pc.queries(args.m)

    # 1. build: the planner chooses engine + parameters and says why
    t0 = time.time()
    index = KNNIndex.build(points, spec)
    print(f"build: {time.time() - t0:.2f}s")
    print(index.describe())

    # 2. query: a QueryResult (unpacks as the classic (dists, idx) tuple)
    #    carrying immutable per-call stats
    t0 = time.time()
    res = index.query(queries, k=10)
    dists, idx = res
    print(f"query: {time.time() - t0:.2f}s for {len(queries)} queries "
          f"(scanned {res.stats.points_scanned / (len(queries) * len(points)):.2%} "
          f"of what brute force would)")

    # 3. verify a slice against the exact brute-force oracle
    check = min(512, len(queries))
    bd, bi = knn_brute(queries[:check], points, 10, device=dev)
    assert np.allclose(dists[:check], bd, rtol=1e-4, atol=1e-4)
    recall = float((idx[:check] == bi).mean())
    print(f"verified vs brute force: recall@10 = {recall:.4f}")

    # 4. out-of-core mode (the paper's §3 contribution): cap the device
    #    memory budget and the planner streams the leaf structure in chunks
    budget = index.resident_bytes() // 3
    chunked = KNNIndex.build(points, spec.replace(memory_budget=budget))
    part = min(2000, len(queries))
    d2, i2 = chunked.query(queries[:part], k=10)
    assert np.allclose(d2, dists[:part], rtol=1e-5)
    print(f"budget {budget / 1e6:.1f}MB -> plan: engine={chunked.engine_name} "
          f"N={chunked.plan.n_chunks} chunks, identical results; device holds "
          f"{chunked.resident_bytes() / 1e6:.1f}MB vs "
          f"{index.resident_bytes() / 1e6:.1f}MB resident")

    # 5. the same door opens every other engine
    print("registered engines:",
          {name: c.description for name, c in available_engines().items()})
    return {"dists": dists, "idx": idx, "recall": recall, "chunked_dists": d2,
            "chunked_idx": i2, "engine": index.engine_name,
            "chunked_engine": chunked.engine_name, "n_chunks": chunked.plan.n_chunks}


if __name__ == "__main__":
    main()
