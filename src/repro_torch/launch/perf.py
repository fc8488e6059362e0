"""Named experiments over three dry-run cells (counterpart of
``repro.launch.perf``): each is a hypothesis -> change -> re-run the cell's
step on the production mesh's meta slots -> re-analyse, through the port's
dry run (``launch/dryrun.py``); results are JSONs under results/perf/.

Cells:
  A. knn_service x knn_1M  (single-pod)  — the paper's own workload
  B. gemma2_27b  x train_4k (single-pod) — the largest memory term
  C. mamba2_370m x train_4k (single-pod) — a small model under TP = 16

Usage: PYTHONPATH=src python -m repro_torch.launch.perf --exp <name>
       (names: b_seq_shard b_remat_dots b_ga8_seq c_dp_only c_seq_shard
               a_bf16_ring a_tree_measure; a_tree_measure runs on cuda:0
               unless --device cpu)
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Optional

import torch

from repro_torch.configs.base import get_config
from repro_torch.configs.shapes import SHAPES
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.roofline.analysis import dominant_term, roofline_terms
from repro_torch.roofline.model_flops import model_flops

__all__ = ["EXPS", "main"]

OUT = "results/perf"


def _train_cell(arch: str, *, policy: dict, cfg_over: Optional[dict] = None,
                data_axes_all: bool = False):
    """A train_4k cell with explicit policy / config overrides, counted as
    the dry run counts it.  ``data_axes_all``: every slot a data replica
    (the model axis of the pod's 16 x 16 taken as a second data axis,
    tp = 1)."""
    mesh = make_production_mesh()
    if data_axes_all:
        from repro_torch.distributed.mesh import SlotMesh

        mesh = SlotMesh(mesh.devices, {"data": 16, "model_dp": 16, "model": 1})
    chips = mesh.size
    shape = SHAPES["train_4k"]
    cfg = get_config(arch).replace(**(cfg_over or {}))
    t0 = time.time()
    costs, memory = dryrun.measure_lm(cfg, shape, mesh, policy=policy)
    terms = roofline_terms(costs.flops_per_device * chips, costs.bytes_per_device * chips,
                           costs.coll_bytes_per_device * chips, chips)
    mf = model_flops(cfg, shape)
    return {
        "roofline": terms, "dominant": dominant_term(terms),
        "memory_gb": memory["peak_bytes"] / 1e9,
        "useful_ratio": mf["spec"] / max(costs.flops_per_device * chips, 1),
        "elapsed_s": time.time() - t0,
    }


# ---------------------------------------------------------------------------
def exp_b_seq_shard():
    """B1: sequence-parallel residual stream for gemma2 train."""
    pol = {"param_mode": "mp_zero1", "grad_accum": 16, "param_dtype": "bfloat16"}
    return _train_cell("gemma2_27b", policy=pol, cfg_over={"seq_shard": True})


def exp_b_remat_dots():
    """B2: remat policy full -> dots (less recompute, more activations)."""
    pol = {"param_mode": "mp_zero1", "grad_accum": 16, "param_dtype": "bfloat16"}
    return _train_cell("gemma2_27b", policy=pol, cfg_over={"remat": "dots"})


def exp_b_ga8_seq():
    """B3: seq-shard + ga 16->8 (fewer microbatch repeats of collectives)."""
    pol = {"param_mode": "mp_zero1", "grad_accum": 8, "param_dtype": "bfloat16"}
    return _train_cell("gemma2_27b", policy=pol, cfg_over={"seq_shard": True})


def exp_c_dp_only():
    """C1: mamba2-370M is far too small for TP=16 — run pure DP over all 256
    slots (params replicated bf16, ZeRO-sharded opt): per-layer sums vanish,
    only the grad reduce-scatter remains."""
    pol = {"param_mode": "mp_zero1", "grad_accum": 1, "param_dtype": "bfloat16"}
    return _train_cell("mamba2_370m", policy=pol, data_axes_all=True)


def exp_c_seq_shard():
    """C2: alternative: keep TP but sequence-shard the residual stream."""
    pol = {"param_mode": "mp_zero1", "grad_accum": 2, "param_dtype": "bfloat16"}
    return _train_cell("mamba2_370m", policy=pol, cfg_over={"seq_shard": True})


def exp_a_bf16_ring():
    """A1: the kNN ring on 2-byte points and queries (halves the slab bytes
    of the dominant memory term; distances rescored exactly afterwards).
    Reckoned from shapes only: the port's leaf-scan kernel reads fp32, f16
    and u8 codes and has no bf16 code type."""
    mesh = make_production_mesh()
    res = dryrun.knn_result(dryrun.knn_cell(mesh, elem_bytes=2), mesh, "knn_1M", False,
                            time.time())
    return {"roofline": {k: res["roofline"][k] for k in ("compute_s", "memory_s",
                                                         "collective_s")},
            "dominant": res["dominant"], "memory_gb": res["memory"]["peak_bytes"] / 1e9,
            "note": "reckoned at 2 bytes an element; the port's kernel has no bf16 code type"}


def exp_a_tree_measure(device=None, dryrun_dir: str = "results/dryrun"):
    """A2: the paper's own lever — tree pruning.  Measure the scanned-work
    fraction of LazySearch vs brute at calibration scale (same d=10 mixture
    data as the cell) and project the cell's compute/memory terms from the
    port's own dry-run JSON (the knn_service cell, reckoned here when that
    file is missing), on ``device`` (default cuda:0)."""
    from repro_torch.core import BufferKDTree
    from repro_torch.data.pipeline import PointCloud

    dev = torch.device(device) if device else torch.device("cuda", 0)
    n_cal, m_cal = 1 << 18, 1 << 13
    pc = PointCloud(n_cal, 10, seed=0)
    idx = BufferKDTree(pc.points(), height=9, tile_q=128, device=dev)
    idx.query(pc.queries(m_cal), k=10)
    frac = idx.stats.points_scanned / (m_cal * n_cal)
    path = dryrun.cell_path(dryrun_dir, dryrun.KNN_ARCH, "knn_1M", False)
    if os.path.exists(path):
        with open(path) as f:
            base = json.load(f)
        src = path
    else:
        base = dryrun.run_cell(dryrun.KNN_ARCH, "knn_1M", False)
        src = "reckoned now (no dry-run JSON at " + path + ")"
    t = {k: base["roofline"][k] for k in ("compute_s", "memory_s", "collective_s")}
    t["compute_s"] *= frac
    t["memory_s"] *= frac
    return {"roofline": t, "dominant": dominant_term(t),
            "pruning_fraction": frac, "device": str(dev), "dryrun_source": src,
            "note": f"tree scans {frac:.3%} of brute-force work "
                    f"(measured n=2^18, m=2^13, h=9, d=10)"}


EXPS = {
    "b_seq_shard": exp_b_seq_shard,
    "b_remat_dots": exp_b_remat_dots,
    "b_ga8_seq": exp_b_ga8_seq,
    "c_dp_only": exp_c_dp_only,
    "c_seq_shard": exp_c_seq_shard,
    "a_bf16_ring": exp_a_bf16_ring,
    "a_tree_measure": exp_a_tree_measure,
}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--exp", required=True, choices=sorted(EXPS))
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--device", default=None,
                    help="a_tree_measure's device (default cuda:0; cpu runs the leaf "
                         "scan's plain version)")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    kw = {"device": args.device} if args.exp == "a_tree_measure" else {}
    res = EXPS[args.exp](**kw)
    path = os.path.join(args.out, f"{args.exp}.json")
    with open(path, "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps(res, indent=1))


if __name__ == "__main__":
    main()
