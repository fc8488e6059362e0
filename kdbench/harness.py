"""One run of one cell: set-up, the measured window, the traced window's
per-layer metrics, the check, and the result line.

Set-up (``setup_s``, from the process's start) makes the catalogue and the
query batch from the seed, builds the index on the cell's cards and warms
it for the cell's batch shape.  The window answers the whole batch back to
back, one client in a closed loop, and starts it again while fewer than
``--seconds`` have passed; ``knn_qps`` is every query answered
over the time from the first batch's start to the last batch's end (host
clock, the answers in numpy).  With ``--trace 1`` the window runs under
the profiler and the line carries the per-layer metrics instead.  Once the
window has closed and the peak memory is read, the index is freed and
``check.judge`` holds the window's answers against the reference.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import subprocess
import sys
import time
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np

from kdbench import catalog, check
from kdbench.trace import Profiler

# whole top-level module names that may not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class NoCards(RuntimeError):
    pass


@dataclasses.dataclass
class Batch:
    """One answered batch of the window, as the readers see it."""

    t0: float
    t1: float
    m: int
    stats: object                          # the program's SearchStats


@dataclasses.dataclass
class Run:
    """What a per-layer metric's ``read(run)`` takes: the cell, the clock
    readings, the program's counters and the trace's summary."""

    cell: catalog.Cell
    build_s: float
    batches: List[Batch]
    trace: Optional[object]                # trace.Summary (traced runs)
    window_s: float


def rate(batches: Sequence[Batch]) -> float:
    """Queries answered per second over the whole window: every batch's
    queries over the time from the first batch's start to the last one's
    end."""
    return sum(b.m for b in batches) / (batches[-1].t1 - batches[0].t0)


def loaded_forbidden() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def cards(chips: int):
    """The cell's cards: cuda:0 .. cuda:chips-1.  Raises ``NoCards`` where
    there is no card or fewer than the cell asks for."""
    import torch

    if not torch.cuda.is_available():
        raise NoCards("torch.cuda.is_available() is false")
    if torch.cuda.device_count() < chips:
        raise NoCards(f"the cell asks for {chips} cards, {torch.cuda.device_count()} visible")
    return [torch.device("cuda", i) for i in range(chips)]


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError):
        return "not read"


def _sync(devices) -> None:
    import torch

    for dev in devices:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


def run(cell: catalog.Cell, seed: int, seconds: float, trace: bool, *, t_start: float,
        devices: Optional[Sequence] = None, log=print) -> dict:
    """Run ``cell`` once; returns the result line's object.  ``devices``
    (tests) replaces the cards the cell would look for."""
    import torch

    if devices is None:
        devices = cards(cell.chips)
    devices = list(devices)
    on_cards = devices[0].type == "cuda"
    from repro_torch.api import IndexSpec, KNNIndex

    cfg, tr = cell.config, cell.traffic
    batch, k = int(tr["batch"]), int(tr["k"])
    points, queries = catalog.data(cell, seed)
    for dev in devices:
        if dev.type == "cuda":
            torch.empty(0, device=dev)   # the card's allocator, before its peak is reset
            torch.cuda.reset_peak_memory_stats(dev)
    spec = IndexSpec(devices=tuple(devices), **catalog.spec_fields(tr))
    t0 = time.perf_counter()
    index = KNNIndex.build(points, spec)
    _sync(devices)
    build_s = time.perf_counter() - t0
    index.warm(batch, k)
    _sync(devices)
    plan = index.plan
    log(f"plan engine={plan.engine} precision={plan.precision} n_chunks={plan.n_chunks} "
        f"n_shards={plan.n_shards} height={plan.height} build_s={build_s}")

    prof = Profiler() if trace else contextlib.nullcontext()
    batches: List[Batch] = []
    answers: List[check.Answer] = []
    setup_s = time.perf_counter() - t_start
    with prof:
        w0 = time.perf_counter()
        while not batches or time.perf_counter() - w0 < seconds:
            b0 = time.perf_counter()
            res = index.query(queries, k)
            b1 = time.perf_counter()
            batches.append(Batch(b0, b1, queries.shape[0], res.stats))
            answers.append(check.Answer(queries, res.dists, res.idx))
    if trace:
        log(f"trace events={prof.events} stop_s={prof.stop_s} reduce_s={prof.reduce_s}")
    window_s = batches[-1].t1 - batches[0].t0
    peak = max((torch.cuda.max_memory_allocated(d) for d in devices if d.type == "cuda"),
               default=0)
    del index, res
    gc.collect()
    if on_cards:
        torch.cuda.empty_cache()

    card = torch.cuda.get_device_name(devices[0]) if on_cards else "cpu"
    runrec = Run(cell=cell, build_s=build_s, batches=batches,
                 trace=prof.summary if trace else None, window_s=window_s)
    qps = rate(batches)
    log(f"window batches={len(batches)} window_s={window_s} knn_qps={qps} setup_s={setup_s} "
        f"rounds={[b.stats.iterations for b in batches]} peak_bytes={peak}")

    sample = check.sample_rows(seed, [b.m for b in batches], int(tr["check_rows"]))
    t0 = time.perf_counter()
    verdict = check.judge(points, answers, sample, cfg["check"], devices[0])
    log(f"check_s={time.perf_counter() - t0} rows={verdict.rows} sampled={verdict.sampled}")

    metrics = {}
    if trace:
        for m in cell.per_layer:
            value = catalog.reader(cell, m["name"])(runrec)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        e2e = {"knn_qps": qps, "setup_s": setup_s}
        if on_cards:
            e2e["peak_mem_gb"] = peak / 1e9
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end if m["name"] in e2e}
    device = {"platform": "gpu" if on_cards else "cpu", "kind": card, "count": len(devices),
              "memory_peak_bytes": int(peak)}
    out = {"correct": verdict.correct, "attempted": sum(b.m for b in batches),
           "failed": verdict.failed, "metrics": metrics, "device": device}
    if trace:
        s = prof.summary
        busy = [s.busy_s.get(d.index if d.index is not None else 0, 0.0) for d in devices]
        device["busy_s"] = float(np.mean(busy))
        device["window_s"] = window_s
        out["breakdown"] = {"device_ops": [[n, v] for n, v in s.device_ops],
                            "idle_gaps": [[n, v] for n, v in s.idle_gaps]}
    out["plan"] = {"engine": plan.engine, "precision": plan.precision,
                   "n_chunks": plan.n_chunks, "n_shards": plan.n_shards}
    out["checked"] = verdict.report()
    log(f"run_s={time.perf_counter() - t_start}")
    return out


def main(argv=None, *, root: Path = catalog.ROOT, devices=None, t_start: Optional[float] = None,
         stdout=None, stderr=None) -> int:
    import argparse

    stdout, stderr = stdout or sys.stdout, stderr or sys.stderr
    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    def log(msg: str) -> None:
        print(f"[kdbench] {msg}", file=stderr, flush=True)

    cell = catalog.load_cell(args.workload, root)
    try:
        out = run(cell, args.seed, args.seconds, bool(args.trace), t_start=t_start,
                  devices=devices, log=log)
    except NoCards as e:
        log(f"no result: {e}")
        return 2
    found = loaded_forbidden()
    if found:
        log(f"no result: modules loaded that the run may not load: {found}")
        return 3
    log(f"card {power_limit()}")
    for name, c in out["checked"].items():
        log(f"check {name}={c['value']!r} limit={c['limit']!r}")
    print(json.dumps(out), file=stdout, flush=True)
    return 0
