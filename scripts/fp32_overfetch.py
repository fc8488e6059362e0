#!/usr/bin/env python3
"""Choose FP32_OVERFETCH: the share of unproven rows of the main cell at each
overfetch, the leaf-scan instance each one runs, and end to end.

    python3 scripts/fp32_overfetch.py              # full size (n = 2**24, m = 2**20)
    python3 scripts/fp32_overfetch.py --shift 4    # n and m divided by 2**4
    python3 scripts/fp32_overfetch.py --end-to-end 2,6   # query_s at 2 and 6

Builds chip_smoke.py's main cell (same data, planner defaults: N = 1 on the
card), runs the chunked engine once at k + 6 (k = 10) and, for each
overfetch o in 2..6, rescores the first k + o candidates exactly and counts
the rows ``certify`` (eps = 0) does not prove.  The engine's candidates are
the exact top list of the decomposed distance, so the first k + o of a
k + 6 run are what a k + o run selects.  Then times the CUDA leaf scan at
the main-path shape (W=4096, TQ=128, L_pad=4096, d=10) at k = 10 + o.
Prints one line per overfetch and a JSON line; needs one CUDA device.

``--end-to-end a,b`` instead builds the main cell's index (chunked engine)
and a jit-engine index once, then queries each at overfetch a, b, b, a
(the order cancels drift of the host clock), the constant set in the
package before each query: query_s, rounds, refined and brute-force rows
per run, and the answers must be the same at every overfetch.  The jit
round of each (m, k) shape is warmed and captured before its first timed
query.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K, OVERFETCHES = 10, (2, 3, 4, 5, 6)


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--shift", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--end-to-end", default="",
                    help="comma-separated overfetches to time end to end (a,b: a b b a)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("fp32_overfetch: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import chip_smoke
    from repro_torch.core.lazysearch import BufferKDTree, certify, finalize_candidates
    from repro_torch.kernels import knn_scan

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = chip_smoke.phase_env(torch)
    points, queries = chip_smoke.main_data(args.seed, args.shift)
    if args.end_to_end:
        return end_to_end(torch, smi, points, queries,
                          [int(o) for o in args.end_to_end.split(",")])
    index = BufferKDTree(points, device=dev)
    q = torch.from_numpy(queries).to(dev)
    k_max = K + max(OVERFETCHES)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    d2, gi, info = index._engine.run(q, k_max, index.engine_tile_q, index.buffer_size)
    run_s = time.perf_counter() - t0
    print(f"[overfetch] n={points.shape[0]} m={queries.shape[0]} h={index.tree.height} "
          f"engine_k={k_max} rounds={info['rounds']} run_s={run_s:.3f}", flush=True)

    s = chip_smoke.MAIN_SHAPE
    w, tq, lp, d = s["w"], s["tq"], s["l_pad"], s["d"]
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    qs = torch.randn((w * tq, d), device=dev, generator=gen)
    x = torch.randn((w, lp, d), device=dev, generator=gen)
    ul = torch.arange(w, dtype=torch.int32, device=dev)
    uq = torch.arange(w * tq, dtype=torch.int32, device=dev).reshape(w, tq)
    nu = torch.tensor(w, dtype=torch.int32, device=dev)
    rows = []
    for o in OVERFETCHES:
        k_eff = K + o
        dists, _ = finalize_candidates(index.tree, queries, gi[:, :k_eff])
        ok = certify(queries, d2[:, :k_eff], dists, K, k_eff, eps=0.0,
                     x_norm_max=index._x_norm_max)
        ms = chip_smoke.cuda_ms(torch, lambda: knn_scan.leaf_scan_units(
            qs, x, ul, uq, nu, k=k_eff), reps=10)
        row = dict(overfetch=o, k_eff=k_eff, unproven=int((~ok).sum()),
                   unproven_share=float((~ok).mean()),
                   variant=knn_scan.choose_variant(d, k_eff, tq, lp).name, kernel_ms=ms)
        rows.append(row)
        chip_smoke.log("overfetch", **row)
    pick = next((r["overfetch"] for r in rows if r["unproven_share"] < 0.01), None)
    print(json.dumps({"card": smi, "rows": rows, "smallest_under_1pct": pick}), flush=True)
    return 0


def end_to_end(torch, smi, points, queries, overfetches) -> int:
    import chip_smoke
    from repro_torch.api import IndexSpec, KNNIndex, engines
    from repro_torch.core import lazysearch

    m = queries.shape[0]
    main = KNNIndex.build(points)
    jit = KNNIndex.build(points, IndexSpec(engine="jit"))
    runs, answers = [], {}
    for o in overfetches + overfetches[::-1]:
        lazysearch.FP32_OVERFETCH = engines.FP32_OVERFETCH = o
        jit.warm(m, K)
        for name, index in (("main", main), ("jit", jit)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = index.query(queries, K)
            query_s = time.perf_counter() - t0
            st = res.stats
            row = dict(cell=name, overfetch=o, query_s=query_s, rounds=st.iterations,
                       refined_rows=st.refined_rows, exact_rows=st.exact_rows)
            runs.append(row)
            chip_smoke.log("end_to_end", **row)
            if name in answers:
                np.testing.assert_allclose(res.dists, answers[name], rtol=1e-5, atol=1e-6)
            answers[name] = res.dists
    print(json.dumps({"card": smi, "runs": runs}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
