"""Serving launcher: requests through the continuous-batching engine, or
(``--knn``) Poisson kNN traffic through the ``KNNServer`` front door.

Counterpart of ``repro.launch.serve`` with the same flags, plus
``--device`` (default cuda: cuda:0).  The model's weights are random,
drawn from ``--seed``.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen15_0_5b --smoke \\
      --requests 8 --slots 4 --max-new 16
  PYTHONPATH=src python -m repro_torch.launch.serve --knn --requests 200 \\
      --rate 500 --deadline-ms 50
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen15_0_5b --smoke \\
      --device cpu
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.base import get_config
from repro_torch.models.model import LanguageModel
from repro_torch.serving.engine import Request, ServeEngine


def _knn_main(args, device: torch.device) -> None:
    """Open-loop Poisson kNN traffic against a KNNServer over a synthetic
    ``streaming`` index: latency percentiles, close reasons, the typed-error
    tallies (shed / purged / failed) and the plan."""
    from repro_torch.api import IndexSpec, KNNIndex
    from repro_torch.serving.knn_server import KNNServer, Overloaded, ServingError

    rng = np.random.default_rng(args.seed)
    points = rng.normal(size=(args.n, args.d)).astype(np.float32)
    index = KNNIndex.build(points, spec=IndexSpec(engine="streaming", k_hint=args.k,
                                                  devices=(device,)))
    queries = rng.normal(size=(args.requests, args.d)).astype(np.float32)
    gaps = rng.exponential(1.0 / args.rate, size=args.requests)

    shed = 0
    errors: dict = {}
    lat_ok = []
    with KNNServer(index, k=args.k, max_batch=args.max_batch,
                   default_deadline_ms=args.deadline_ms,
                   max_queue=args.max_queue) as server:
        t0 = time.perf_counter()
        tickets = []
        for i in range(args.requests):
            time.sleep(gaps[i])
            try:
                tickets.append(server.submit(queries[i]))
            except Overloaded:
                shed += 1
        for t in tickets:
            try:
                t.result(timeout=120.0)
                lat_ok.append(t.info["latency_s"] * 1e3)
            except ServingError as e:     # DeadlineExceeded, batch errors
                name = type(e).__name__
                errors[name] = errors.get(name, 0) + 1
        dt = time.perf_counter() - t0
        stats = server.stats()

    lat = np.array(lat_ok) if lat_ok else np.zeros(1)
    print(f"[serve --knn] {args.requests} requests in {dt:.2f}s "
          f"({len(lat_ok) / dt:.1f} q/s goodput, offered rate {args.rate:.0f}/s)")
    print(f"  ok={len(lat_ok)} shed={shed} errors={errors or '{}'} "
          f"(server: purged={stats['purged']} failed={stats['failed']})")
    print(f"  latency ms (ok): p50={np.percentile(lat, 50):.2f} "
          f"p99={np.percentile(lat, 99):.2f} max={lat.max():.2f}")
    print(f"  batches={stats['batches']} close reasons: "
          f"{stats['batches_by_close']} buckets={stats['buckets']}")
    print(index.describe())


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--knn", action="store_true",
                    help="serve synthetic kNN traffic through KNNServer "
                         "instead of LM decode")
    ap.add_argument("--arch")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="the device of the model or the index (cuda: cuda:0)")
    # --knn traffic knobs
    ap.add_argument("--n", type=int, default=20_000, help="datastore size")
    ap.add_argument("--d", type=int, default=8)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--rate", type=float, default=500.0,
                    help="Poisson arrival rate (req/s)")
    ap.add_argument("--max-batch", type=int, default=256)
    ap.add_argument("--deadline-ms", type=float, default=50.0)
    ap.add_argument("--max-queue", type=int, default=None,
                    help="bound the admission queue: submits past this depth are "
                         "shed with the typed Overloaded (default: unbounded)")
    args = ap.parse_args(argv)
    device = torch.device("cuda", 0) if args.device == "cuda" else torch.device("cpu")

    if args.knn:
        _knn_main(args, device)
        return
    if args.arch is None:
        ap.error("--arch is required unless --knn is given")

    cfg = get_config(args.arch, smoke=args.smoke)
    lm = LanguageModel(cfg, device=device,
                       generator=torch.Generator(device=device).manual_seed(args.seed))
    eng = ServeEngine(lm, slots=args.slots, max_len=256, seed=args.seed)

    rng = np.random.default_rng(args.seed)
    t0 = time.time()
    for rid in range(args.requests):
        plen = int(rng.integers(3, 12))
        eng.submit(Request(
            rid=rid,
            prompt=rng.integers(0, cfg.vocab_size, plen).astype(np.int32),
            max_new_tokens=args.max_new,
            temperature=args.temperature,
        ))
    done = eng.run()
    dt = time.time() - t0
    total_new = sum(len(r.out_tokens) for r in done.values())
    print(f"[serve] {len(done)} requests, {total_new} tokens in {dt:.2f}s "
          f"({total_new / dt:.1f} tok/s)")
    for rid in sorted(done):
        print(f"  req {rid}: {done[rid].out_tokens}")


if __name__ == "__main__":
    main()
