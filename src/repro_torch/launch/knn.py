"""kNN service launcher: the paper's own workload as a command.

Counterpart of ``repro.launch.knn``.  Builds a ``repro_torch.api.KNNIndex``
over a reference catalogue and answers one batch of kNN queries.  With no
flags the planner picks the engine from the data's shape, the device slots
and the (optional) memory budget; every plan decision is printed with its
reason.  ``--device`` and ``--slots`` give the slots (the reference takes
them from ``jax.devices()`` and ``XLA_FLAGS``): ``--slots 4`` repeats the
device four times, four slots on one card (or on the CPU), which plans the
``forest`` engine when n splits into four.

``--append P`` runs the batch-dynamic path: the index is planned mutable
(the ``dynamic`` engine; an immutable ``--engine`` with ``--append`` fails
at plan time with a ValueError), P more points are inserted in
``--append-batches`` batches after the build, with each batch's time, and
the check runs against brute force over the grown set.

Example:
  PYTHONPATH=src python -m repro_torch.launch.knn --n 100000 --m 10000 --d 10 \\
      --k 10 --chunks 3
  PYTHONPATH=src python -m repro_torch.launch.knn --n 100000 --slots 4
  PYTHONPATH=src python -m repro_torch.launch.knn --n 100000 --engine ring --slots 4
  PYTHONPATH=src python -m repro_torch.launch.knn --n 100000 --device cpu --slots 4
  PYTHONPATH=src python -m repro_torch.launch.knn --n 100000 --memory-budget 4000000
  PYTHONPATH=src python -m repro_torch.launch.knn --n 100000 --append 20000
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.api import IndexSpec, KNNIndex, knn_brute
from repro_torch.data.pipeline import PointCloud


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--m", type=int, default=10_000)
    ap.add_argument("--d", type=int, default=10)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--height", type=int, default=0, help="0 = auto")
    ap.add_argument("--chunks", type=int, default=0, help="0 = auto")
    ap.add_argument("--engine", type=str, default=None,
                    help="registry engine name; default = planner's choice")
    ap.add_argument("--memory-budget", type=int, default=0,
                    help="device bytes for the leaf structure (0 = unlimited)")
    ap.add_argument("--append", type=int, default=0,
                    help="insert this many extra points incrementally after "
                         "the build (plans a mutable index)")
    ap.add_argument("--append-batches", type=int, default=4,
                    help="number of insert batches --append is split into")
    ap.add_argument("--sync-merges", action="store_true",
                    help="pin the dynamic engine's carry merges to the "
                         "insert path (default: background staging worker)")
    ap.add_argument("--verify", type=int, default=256,
                    help="verify this many queries against brute force")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="the device of the slots (cuda: every visible card "
                         "unless --slots is given, then cuda:0)")
    ap.add_argument("--slots", type=int, default=0,
                    help="repeat the device this many times, one slot each "
                         "(0: every visible card, or one CPU slot)")
    args = ap.parse_args(argv)

    if args.slots:
        devices = (torch.device(args.device, 0) if args.device == "cuda"
                   else torch.device("cpu"),) * args.slots
    elif args.device == "cpu":
        devices = (torch.device("cpu"),)
    else:
        devices = None   # every visible card

    pc = PointCloud(args.n, args.d, seed=args.seed)
    pts = pc.points()
    q = pc.queries(args.m)

    spec = IndexSpec(
        engine=args.engine,
        height=args.height or None,
        n_chunks=args.chunks or None,
        memory_budget=args.memory_budget or None,
        k_hint=args.k,
        m_hint=args.m,
        devices=devices,
        mutable=True if args.append else None,
        merge_async=False if args.sync_merges else None,
    )
    t0 = time.time()
    idx = KNNIndex.build(pts, spec=spec)
    t_build = time.time() - t0
    print(idx.describe())
    t0 = time.time()
    res = idx.query(q, k=args.k)
    t_query = time.time() - t0
    print(f"[knn] n={args.n} m={args.m} d={args.d} k={args.k} "
          f"engine={idx.engine_name} chunks={idx.plan.n_chunks} "
          f"h={idx.height}")
    line = (f"[knn] train {t_build:.2f}s  test {t_query:.2f}s  "
            f"({args.m / t_query:.0f} q/s)")
    if res.stats.points_scanned:   # not every engine reports scan volume
        scanned = res.stats.points_scanned / max(1, args.m * args.n)
        line += f"  scanned {scanned:.3%} of brute"
    print(line)

    lead = idx.spec.devices[0]
    if args.append:
        extra = PointCloud(args.append, args.d, seed=args.seed + 1).points()
        batches = np.array_split(extra, max(1, args.append_batches))
        t_ingest = 0.0
        for i, batch in enumerate(batches):
            t0 = time.time()
            idx.insert(batch)
            dt = time.time() - t0
            t_ingest += dt
            print(f"[knn] append batch {i}: +{batch.shape[0]} pts in "
                  f"{dt:.3f}s ({batch.shape[0] / max(dt, 1e-9):.0f} pts/s)")
        print(f"[knn] append total: +{args.append} pts in {t_ingest:.2f}s "
              f"(full rebuild took {t_build:.2f}s for {args.n})")
        t0 = time.time()
        idx.drain()
        state = idx._state  # dynamic engine: report the forest's placement
        print(f"[knn] background merges drained in {time.time() - t0:.3f}s "
              f"({state.merge_stats()})")
        placed = {}
        for cap, kind, slot in state.placement():
            placed.setdefault(f"{idx.spec.devices[slot]} (slot {slot})", []).append(
                f"{kind}:{cap}")
        for dev, shards in placed.items():
            print(f"[knn]   {dev}: {' '.join(shards)}")
        pts = np.concatenate([pts, extra])
        t0 = time.time()
        res = idx.query(q, k=args.k)
        print(f"[knn] post-append test {time.time() - t0:.2f}s over "
              f"n={idx.n}")

    if args.verify:
        v = min(args.verify, args.m)
        bd, bi = knn_brute(q[:v], pts, args.k, device=lead)
        ok = np.allclose(res.dists[:v], bd, rtol=1e-4, atol=1e-4)
        recall = float((res.idx[:v] == bi).mean())
        print(f"[knn] verify: dists_ok={ok} recall@{args.k}={recall:.4f}")


if __name__ == "__main__":
    main()
