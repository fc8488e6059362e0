"""The check's control: the reference put in the program's place, in TF32,
judged by the same comparison as the program's answers.

    python3 kdbench/control.py --workload <cell> --seeds 11,12,13

For each seed it makes the cell's catalogue and query batch, draws
the rows the check would sample, answers them with ``reference.knn_tf32``
and prints the numbers ``check.judge`` gives them, one JSON line a seed.
Each has to fail the cell's limits (``kdbench/tests`` holds the same at a
tiny size on the CPU).  The benchmark's own runs do not run it.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def control(cell, seed: int, device) -> dict:
    """The control's verdict on ``cell`` at ``seed``."""
    import numpy as np
    import torch

    from kdbench import catalog, check
    from kdbench.reference import knn_tf32

    cfg, tr = cell.config, cell.traffic
    points, queries = catalog.data(cell, seed)
    (rows,) = check.sample_rows(seed, [queries.shape[0]], int(tr["check_rows"]))
    q = queries[rows]
    d, i = knn_tf32(torch.from_numpy(points).to(device), torch.from_numpy(q).to(device),
                    int(tr["k"]))
    answer = check.Answer(q, d.cpu().numpy(), i.cpu().numpy())
    verdict = check.judge(points, [answer], [np.arange(q.shape[0])], cfg["check"], device)
    return {"seed": seed, "correct": verdict.correct, "sampled": verdict.sampled,
            "checked": verdict.report()}


def main(argv=None) -> int:
    import argparse

    import torch

    from kdbench import catalog

    ap = argparse.ArgumentParser(description="Run the check's control.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    args = ap.parse_args(argv)
    cell = catalog.load_cell(args.workload, ROOT)
    device = torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu")
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        out = control(cell, seed, device)
        out["seconds"] = time.perf_counter() - t0
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.path[:0] = [str(ROOT)]
    sys.exit(main())
