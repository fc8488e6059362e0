"""Pod-scale dry run: run every (arch x shape x mesh) cell's step once on
``meta`` device slots, count it, and write its roofline.

Counterpart of ``repro.launch.dryrun``.  The reference lowers and compiles
each cell for 256 / 512 placeholder TPU devices and reads XLA's memory and
cost analyses.  The port runs the cell's own step (``ShardedLM`` and
``make_sharded_train_step``, or prefill / ``decode_step``) once on the
production mesh (``launch/mesh.py::make_production_mesh``: every slot on
``meta``, so nothing is allocated) under the counters of
``roofline/calibrate.py`` (FLOPs, bytes accessed, peak live bytes) and
``roofline/analysis.py`` (collectives), and per cell:

  1. ``argument_bytes`` per slot, exact, from the specs of the full-depth
     cell: parameters, optimizer state (moments, the fp32 master under
     mp_zero1, the count), the step, the batch, and the decode caches;
  2. FLOPs, bytes and collective bytes per slot counted at G in {1, 2}
     layer groups and extrapolated to the true depth (``calibrated_costs``;
     ``--no-calibrate`` counts the full depth directly), the train step at
     grad_accum 1 on the whole batch, as the reference calibrates;
  3. ``temp_bytes`` per slot: the peak live bytes of the meta run (a
     dispatch mode that tracks each storage an op creates until it is
     freed), extrapolated from G in {1, 2} like the costs.  A train step
     with grad_accum > 1 is counted for memory on one microbatch's rows at
     grad_accum 1, plus the fp32 accumulator the step keeps across
     microbatches (the gradients in their reduced layout);
     ``peak_bytes`` = argument + temp, held against the card's 80 GB;
  4. the three roofline terms on an H100 (``roofline.HW``), MODEL_FLOPS
     and their ratio, into one JSON per cell under ``--out``.

The kNN-service cell (``--arch knn_service``) is reckoned from shapes: the
ring (``distributed/ring_knn.py``) launches the CUDA leaf scan, which
cannot run on ``meta``.  ``knn_ring_launches`` lists the launches the ring
makes, by its own slab and grouping rules, and each launch costs the leaf
scan's operations W TQ L_pad (2d + 3) and bytes (every unit's slab rows
and query tile read once, its lists written once): the kernel's roofline,
the same work whatever implements it.  Its collectives are the query
blocks (and their running lists) handed from slot to slot.

Where a cell's batch does not split over every data axis (long_500k's
batch of 1), the outer axes replicate it, as GSPMD does: each of their rows
runs the whole batch (``_tiled``).

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2_7b --shape train_4k [--multi-pod]
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--jobs N]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import subprocess
import sys
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ARCH_IDS, get_config
from repro_torch.configs.shapes import SHAPES, cell_supported, effective_data_axes, input_specs
from repro_torch.distributed.mesh import shard_shape
from repro_torch.launch.mesh import data_axes_of, make_production_mesh, tp_of
from repro_torch.roofline.analysis import HW, dominant_term, roofline_terms
from repro_torch.roofline.calibrate import (
    OpCounts,
    calibrated_costs,
    count_ops,
    meta_memo,
    temp_bytes_of,
)
from repro_torch.roofline.model_flops import model_flops, param_counts

__all__ = ["KNN_ARCH", "TRAIN_POLICY", "train_policy", "SERVE_KV_DTYPE", "KNN_N", "KNN_D",
           "KNN_M", "KNN_K", "KNN_TREE_H", "MetaStep", "compile_train", "compile_prefill",
           "compile_decode", "knn_ring_launches", "leaf_scan_work", "knn_cell", "measure_lm",
           "knn_result", "run_cell", "cell_path",
           "all_cells", "main"]

KNN_ARCH = "knn_service"
META = torch.device("meta")
# the card the roofline is drawn for (roofline/analysis.py::HW)
CARD = "NVIDIA H100 SXM5 80GB at a 700 W power limit (data-sheet peaks)"

# Baseline production training policy per arch (the reference's memory-fit
# choices, recorded in the JSON).  zero1 = ZeRO-1 moments, fsdp =
# params+moments sharded over batch axes; grad_accum = microbatching.
TRAIN_POLICY = {
    "default": {"param_mode": "zero1", "grad_accum": 1, "param_dtype": "float32"},
    "stablelm_1_6b": {"param_mode": "mp_zero1", "grad_accum": 2,
                      "param_dtype": "bfloat16"},
    "qwen15_0_5b": {"param_mode": "mp_zero1", "grad_accum": 2,
                    "param_dtype": "bfloat16"},
    "mamba2_370m": {"param_mode": "mp_zero1", "grad_accum": 2,
                    "param_dtype": "bfloat16"},
    "qwen2_7b": {"param_mode": "mp_zero1", "grad_accum": 4,
                 "param_dtype": "bfloat16"},
    "gemma2_27b": {"param_mode": "mp_zero1", "grad_accum": 16,
                   "param_dtype": "bfloat16"},
    "llava_next_mistral_7b": {"param_mode": "mp_zero1", "grad_accum": 8,
                              "param_dtype": "bfloat16"},
    "recurrentgemma_9b": {"param_mode": "mp_zero1", "grad_accum": 8,
                          "param_dtype": "bfloat16"},
    "moonshot_v1_16b_a3b": {"param_mode": "mp_zero1", "grad_accum": 8,
                            "param_dtype": "bfloat16"},
    "olmoe_1b_7b": {"param_mode": "mp_zero1", "grad_accum": 2,
                    "param_dtype": "bfloat16"},
    "hubert_xlarge": {"param_mode": "zero1", "grad_accum": 2,
                      "param_dtype": "float32"},
}


def train_policy(arch: str) -> dict:
    return TRAIN_POLICY.get(arch, TRAIN_POLICY["default"])


# Serving policy: archs whose 32k KV cache is held int8
# (models/attention.py's quantized cache).
SERVE_KV_DTYPE = {
    "moonshot_v1_16b_a3b": "int8",   # 48 layers x 16 kv heads at 32k
    "gemma2_27b": "int8",            # 23 global layers at 32k, multi-pod fit
}

# the kNN service cell (the paper's own workload on the production mesh)
KNN_N = 1 << 27          # 134M reference points, d=10 (crts-like), f32
KNN_D = 10
KNN_M = 1 << 20          # 1M queries per step
KNN_K = 10
KNN_TREE_H = 7           # per-shard trees: n_local = N/16 = 8.4M, leaf ~64k


def _arch_id(cfg) -> str:
    return cfg.name.replace("-", "_").replace(".", "_")


def _nbytes(shape, dtype) -> int:
    return math.prod(shape) * torch.empty((), dtype=dtype).element_size()


def _slot_bytes(shapes: Dict[str, tuple], specs: Dict[str, tuple], dtypes, mesh) -> int:
    """Slot 0's bytes of the tensors ``shapes`` placed by ``specs`` (slot 0
    holds the largest shards under the ceil split; every slot of the
    reference's SPMD program holds buffers that size)."""
    return sum(_nbytes(shard_shape(shapes[n], specs[n], mesh, 0),
                       dtypes[n] if isinstance(dtypes, dict) else dtypes) for n in shapes)


def _groups_cfg(cfg, n_groups: Optional[int]):
    if n_groups is None:
        return cfg
    return cfg.replace(n_layers=cfg.group_size() * n_groups + cfg.n_remainder(),
                       scan_layers=False)


def _tiled(batch: Dict[str, torch.Tensor], shape, mesh, dax) -> Dict[str, torch.Tensor]:
    """The batch as the port's sharded model takes it: rows split over every
    data axis.  The outer data axes ``effective_data_axes`` drops replicate
    the batch, so each of their rows gets all of it."""
    eff = effective_data_axes(shape.global_batch, dax, mesh)
    rep = math.prod(mesh.shape[a] for a in dax if a not in eff)
    if rep == 1:
        return batch
    return {k: (torch.cat([v] * rep) if v.dim() >= 1 else v) for k, v in batch.items()}


def _batch_bytes(cfg, batch, bspecs, mesh) -> int:
    """Slot 0's bytes of the batch the step reads: a decode step's ``pos``
    only where an attention layer places its token by it (the reference's
    jit drops an argument the program never reads)."""
    attends = any(kind in ("global", "local") for kind, _ in cfg.layer_kinds())
    return sum(_nbytes(shard_shape(t.shape, bspecs[k], mesh, 0), t.dtype)
               for k, t in batch.items() if k != "pos" or attends)


@dataclasses.dataclass
class MetaStep:
    """A cell's step built on the mesh's meta slots: ``run()`` runs it once;
    the byte counts are slot 0's."""
    run: Callable[[], Any]
    slots: int
    argument_bytes: int
    output_bytes: int
    extra_temp_bytes: int = 0     # held beside the run's own peak (the
                                  # grad_accum accumulator)

    def count(self) -> OpCounts:
        return count_ops(self.run, self.slots)


def compile_train(cfg, shape, mesh, n_groups: Optional[int] = None,
                  policy: Optional[dict] = None, *, microbatch: bool = False,
                  build: bool = True) -> MetaStep:
    """The sharded train step of ``cfg`` at ``shape`` on ``mesh`` (at
    ``n_groups`` layer groups when given, at grad_accum 1 on the whole
    batch: the costs; with ``microbatch`` on one microbatch's rows: the
    memory).  ``build=False`` only sizes the arguments (full depth)."""
    from repro_torch.models import LanguageModel
    from repro_torch.training.optimizer import Hyper
    from repro_torch.training.step import make_sharded_train_step, sharded_adamw_init

    policy = policy or train_policy(_arch_id(cfg))
    cfg = _groups_cfg(cfg, n_groups).replace(param_dtype=policy.get("param_dtype", "float32"))
    dax = data_axes_of(mesh)
    ga = policy["grad_accum"]
    with meta_memo():
        lm = LanguageModel(cfg, tp=tp_of(mesh), device=META)
    batch, bspecs = input_specs(cfg, shape, dax, mesh)
    step, specs = make_sharded_train_step(lm, Hyper(grad_accum=1), mesh, data_axes=dax,
                                          param_mode=policy["param_mode"])
    dtypes = {n: p.dtype for n, p in lm.named_parameters()}
    shapes = specs["shapes"]
    params_b = _slot_bytes(shapes, specs["params"], dtypes, mesh)
    opt_b = 4 + sum(_slot_bytes(shapes, specs["opt"][k], torch.float32, mesh)
                    for k in ("m", "v", "master") if k in specs["opt"])
    arg = params_b + opt_b + _batch_bytes(cfg, batch, bspecs, mesh) + 4   # + the step
    acc = _slot_bytes(shapes, specs["grads"], torch.float32, mesh) if ga > 1 else 0
    if not build:   # extra_temp_bytes: what a full step holds beside a microbatch's
        return MetaStep(lambda: None, mesh.size, arg, params_b + opt_b, acc)
    if microbatch and ga > 1:
        # one microbatch's rows, at least one per data row (a microbatch
        # the data rows do not divide is padded to a row each, as GSPMD
        # pads an uneven split)
        n_rows = math.prod(mesh.shape[a] for a in dax)
        rows = -(-(shape.global_batch // ga) // n_rows) * n_rows
        batch = {k: v[:rows] for k, v in batch.items()}
    batch = _tiled(batch, shape, mesh, dax)
    with meta_memo():
        params = lm.shard(specs["dist"], specs["params"])
        opt = sharded_adamw_init(params, specs["opt"])
    return MetaStep(lambda: step(params, opt, batch, 0), mesh.size, arg, params_b + opt_b,
                    acc if microbatch else 0)


def _serve_model(cfg, mesh):
    from repro_torch.models import LanguageModel
    from repro_torch.models.transformer import Dist

    dax = data_axes_of(mesh)
    dist = Dist(mesh=mesh, data_axes=dax, model_axis="model", tp=tp_of(mesh))
    with meta_memo():
        lm = LanguageModel(cfg, tp=tp_of(mesh), device=META)
    dtypes = {n: p.dtype for n, p in lm.named_parameters()}
    specs = lm.sharded_specs(lm.param_specs(), dax)
    shapes = {n: tuple(p.shape) for n, p in lm.named_parameters()}
    return lm, dist, _slot_bytes(shapes, specs, dtypes, mesh)


def _cache_bytes(cfg, dist, batch: int, max_len: int) -> int:
    """Slot 0's bytes of the decode caches (``ShardedLM.cache_specs``)."""
    from repro_torch.models import attention, rglru, ssm
    from repro_torch.models.sharded import ShardedLM

    probe = ShardedLM(cfg, dist, [dict() for _ in range(dist.mesh.size)], {}, {})
    total = 0
    for i, (kind, _) in enumerate(cfg.layer_kinds()):
        if kind in ("global", "local"):
            full = attention.make_cache(cfg, batch, max_len,
                                        cfg.window if kind == "local" else 0, META)
        elif kind == "rglru":
            full = rglru.make_rglru_state(cfg, batch, META)
        else:
            full = ssm.make_ssm_state(cfg, batch, META)
        sp = probe.cache_specs(i)
        total += sum(_nbytes(shard_shape(t.shape, sp[n], dist.mesh, 0), t.dtype)
                     for n, t in full.items())
    return total


def _logits_bytes(cfg, batch: int) -> int:
    from repro_torch.models.layers import padded_vocab

    return batch * padded_vocab(cfg) * 4


def compile_prefill(cfg, shape, mesh, n_groups: Optional[int] = None, *,
                    build: bool = True) -> MetaStep:
    """Serving prefill at ``shape`` on ``mesh``: bf16 weights, the residual
    stream split along the sequence (``seq_shard``)."""
    cfg = _groups_cfg(cfg, n_groups).replace(param_dtype="bfloat16", seq_shard=True)
    dax = data_axes_of(mesh)
    lm, dist, params_b = _serve_model(cfg, mesh)
    batch, bspecs = input_specs(cfg, shape, dax, mesh)
    cache_dax = effective_data_axes(shape.global_batch, dax, mesh)
    rows = shape.global_batch // max(1, math.prod(mesh.shape[a] for a in cache_dax))
    out = _logits_bytes(cfg, shape.global_batch) + _cache_bytes(
        cfg, dist, rows * math.prod(mesh.shape[a] for a in dax), shape.seq_len)
    arg = params_b + _batch_bytes(cfg, batch, bspecs, mesh)
    if not build:
        return MetaStep(lambda: None, mesh.size, arg, out)
    batch = _tiled(batch, shape, mesh, dax)
    with meta_memo():
        params = lm.shard(dist)
    return MetaStep(lambda: params.prefill(batch), mesh.size, arg, out)


def compile_decode(cfg, shape, mesh, n_groups: Optional[int] = None, *,
                   build: bool = True) -> MetaStep:
    """One decode step against a cache of ``shape.seq_len``: bf16 weights,
    the KV cache in ``SERVE_KV_DTYPE``'s dtype (bf16 otherwise)."""
    kvd = SERVE_KV_DTYPE.get(_arch_id(cfg), "bfloat16")
    cfg = _groups_cfg(cfg, n_groups).replace(param_dtype="bfloat16", kv_cache_dtype=kvd)
    dax = data_axes_of(mesh)
    lm, dist, params_b = _serve_model(cfg, mesh)
    batch, bspecs = input_specs(cfg, shape, dax, mesh)
    cache_dax = effective_data_axes(shape.global_batch, dax, mesh)
    rows = shape.global_batch // max(1, math.prod(mesh.shape[a] for a in cache_dax))
    tiled_b = rows * math.prod(mesh.shape[a] for a in dax)
    caches_b = _cache_bytes(cfg, dist, tiled_b, shape.seq_len)
    arg = params_b + _batch_bytes(cfg, batch, bspecs, mesh) + caches_b
    out = _logits_bytes(cfg, shape.global_batch) + caches_b
    if not build:
        return MetaStep(lambda: None, mesh.size, arg, out)
    batch = _tiled(batch, shape, mesh, dax)
    with meta_memo():
        params = lm.shard(dist)
        caches = params.init_cache(tiled_b, shape.seq_len)
    return MetaStep(lambda: params.decode_step(batch, caches), mesh.size, arg, out)


_COMPILERS = {"train": compile_train, "prefill": compile_prefill, "decode": compile_decode}


# --------------------------------------------------------------------------
# the kNN service cell, reckoned from shapes
# --------------------------------------------------------------------------
def knn_ring_launches(n: int, m: int, d: int, p: int, tq: int = 128) -> List[Tuple[int, int,
                                                                                 int, int]]:
    """The leaf-scan launches (W units, TQ, L_pad, d) of one query of ``m``
    rows on a ring of ``p`` slots over ``n`` points (``ring_shards`` /
    ``_scan_merge``: shards of ceil(n / p) rows in slabs of L_pad rows,
    blocks of ceil(m / p) queries in tiles of TQ, ``RING_UNITS`` units a
    launch), over every slot and ring step."""
    from repro_torch.distributed.ring_knn import RING_SLAB, RING_UNITS

    nb = -(-n // p)
    l_pad = min(RING_SLAB, -(-nb // 8) * 8)
    n_slabs = -(-nb // l_pad)
    mb = -(-m // p)
    n_tiles = -(-mb // tq)
    group = max(1, RING_UNITS // n_slabs)
    per_step = [(min(group, n_tiles - t0) * n_slabs, tq, l_pad, d)
                for t0 in range(0, n_tiles, group)]
    return per_step * (p * p)


def leaf_scan_work(w: int, tq: int, l_pad: int, d: int, k: int,
                   elem_bytes: int = 4) -> Tuple[float, float]:
    """(operations, bytes) of one leaf-scan launch of ``w`` units on rows of
    ``elem_bytes``-byte elements (4: fp32): per (query, row) pair d FMAs
    for q.x (2d operations) plus 3 to form, clamp and compare the distance;
    every unit's slab rows and query tile read once, the plan read once,
    its k-lists written once."""
    ops = w * tq * l_pad * (2 * d + 3)
    nbytes = (elem_bytes * (w * l_pad * d + w * tq * d) + 4 * (w + w * tq)
              + 8 * w * tq * k)
    return float(ops), float(nbytes)


def knn_cell(mesh, elem_bytes: int = 4) -> Dict[str, Any]:
    """The knn_service cell's per-slot work, from shapes: each data row of
    the mesh is one ring over the ``model`` axis holding all KNN_N points
    (a shard of N / P per slot), and answers its KNN_M / rows queries.
    ``elem_bytes`` = 2 reckons the ring on 2-byte points and queries (the
    perf launcher's ``a_bf16_ring``)."""
    from repro_torch.core.lazysearch import FP32_OVERFETCH
    from repro_torch.distributed.ring_knn import RING_SLAB

    p = mesh.shape["model"]
    rows = mesh.size // p
    m_ring = -(-KNN_M // rows)
    k_eff = KNN_K + FP32_OVERFETCH
    launches = knn_ring_launches(KNN_N, m_ring, KNN_D, p)
    ops = bytes_ = 0.0
    for w, tq, lp, d in launches:
        o, b = leaf_scan_work(w, tq, lp, d, min(k_eff, lp), elem_bytes)
        ops, bytes_ = ops + o, bytes_ + b
    nb = -(-KNN_N // p)
    l_pad = min(RING_SLAB, -(-nb // 8) * 8)
    n_slabs = -(-nb // l_pad)
    mb = -(-m_ring // p)
    block = mb * KNN_D * elem_bytes + mb * k_eff * (4 + 8)   # queries + running list
    w, tq, lp, _ = max(launches)
    kl = min(k_eff, lp)
    g_rows = w // n_slabs * tq
    temp = (w * tq * kl * 8                                # one launch's lists
            + 2 * g_rows * (k_eff + n_slabs * kl) * 12     # candidates + their ids
            + 2 * block)                                   # the block handed on
    return {
        "flops_per_slot": ops / p, "bytes_per_slot": bytes_ / p,
        "coll_per_slot": float(block * (p - 1)),
        "launches_per_slot": len(launches) / p,
        "argument_bytes": (n_slabs * l_pad + mb) * KNN_D * elem_bytes,
        "output_bytes": mb * KNN_K * (4 + 8), "temp_bytes": temp,
        "ring": {"p": p, "rows": rows, "m_per_ring": m_ring, "l_pad": l_pad,
                 "slabs": n_slabs, "block_rows": mb, "k_eff": k_eff},
    }


# --------------------------------------------------------------------------
# cell runner
# --------------------------------------------------------------------------
def _memory(arg: float, out: float, temp: float) -> Dict[str, Any]:
    peak = arg + temp
    return {"argument_bytes": int(arg), "output_bytes": int(out), "temp_bytes": int(temp),
            "peak_bytes": int(peak), "fits_80g": peak < HW["hbm_bytes"],
            "capacity_bytes": HW["hbm_bytes"]}


def _roofline(terms: Dict[str, float]) -> Dict[str, Any]:
    return dict(terms, card=CARD, hw=dict(HW))


def knn_result(c: Dict[str, Any], mesh, shape_name: str, multi_pod: bool,
               t0: float) -> Dict[str, Any]:
    """The knn_service cell's JSON from ``knn_cell``'s reckoning."""
    arch, chips = KNN_ARCH, mesh.size
    flops_tot = c["flops_per_slot"] * chips
    bytes_tot = c["bytes_per_slot"] * chips
    coll_tot = c["coll_per_slot"] * chips
    terms = roofline_terms(flops_tot, bytes_tot, coll_tot, chips)
    useful = 2.0 * KNN_M * KNN_N * KNN_D  # distance cross-term matmul
    return {
        "arch": arch, "shape": shape_name, "multi_pod": multi_pod,
        "chips": chips, "supported": True,
        "memory": _memory(c["argument_bytes"], c["output_bytes"], c["temp_bytes"]),
        "costs": {"flops_total": flops_tot, "bytes_total": bytes_tot,
                  "coll_bytes_total": coll_tot,
                  "coll_detail": {"per_op": {"collective-permute": c["coll_per_slot"]},
                                  "ring": c["ring"],
                                  "launches_per_slot": c["launches_per_slot"]}},
        "roofline": _roofline(terms),
        "dominant": dominant_term(terms),
        "model_flops": {"spec": useful, "refined": useful},
        "useful_ratio": useful / max(flops_tot, 1.0),
        "elapsed_s": time.time() - t0,
    }


def measure_lm(cfg, shape, mesh, *, calibrate: bool = True, policy: Optional[dict] = None):
    """(``CellCosts`` per slot, the memory entry) of ``cfg``'s step at
    ``shape`` on ``mesh`` (``policy``: the train step's, default
    ``train_policy``)."""
    compiler = _COMPILERS[shape.kind]
    kw = {"policy": policy} if shape.kind == "train" else {}
    full = compiler(cfg, shape, mesh, None, build=False, **kw)
    scanned = calibrate and cfg.n_groups() > 1
    costs = calibrated_costs(lambda g: compiler(cfg, shape, mesh, g, **kw).count(),
                             cfg.n_groups(), scanned=scanned)
    mem_costs = costs
    if full.extra_temp_bytes:   # a train step with grad_accum > 1
        mem_costs = calibrated_costs(
            lambda g: compiler(cfg, shape, mesh, g, microbatch=True, **kw).count(),
            cfg.n_groups(), scanned=scanned)
    temp = temp_bytes_of(mem_costs, cfg.n_groups()) + full.extra_temp_bytes
    memory = _memory(full.argument_bytes, full.output_bytes, temp)
    if mem_costs is not costs:
        memory["microbatch_points"] = {str(g): v for g, v in mem_costs.points.items()}
        memory["accumulator_bytes"] = int(full.extra_temp_bytes)
    return costs, memory


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             calibrate: bool = True) -> Dict[str, Any]:
    mesh = make_production_mesh(multi_pod=multi_pod)
    chips = mesh.size
    t0 = time.time()

    if arch == KNN_ARCH:
        return knn_result(knn_cell(mesh), mesh, shape_name, multi_pod, t0)

    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    ok, reason = cell_supported(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "multi_pod": multi_pod,
                "supported": False, "skip_reason": reason}

    costs, memory = measure_lm(cfg, shape, mesh, calibrate=calibrate)
    flops_tot = costs.flops_per_device * chips
    bytes_tot = costs.bytes_per_device * chips
    coll_tot = costs.coll_bytes_per_device * chips
    terms = roofline_terms(flops_tot, bytes_tot, coll_tot, chips)
    mf = model_flops(cfg, shape)

    return {
        "arch": arch, "shape": shape_name, "multi_pod": multi_pod,
        "chips": chips, "supported": True,
        "train_policy": train_policy(arch) if shape.kind == "train" else None,
        "params": param_counts(cfg),
        "memory": memory,
        "costs": costs.as_dict() | {
            "flops_total": flops_tot,
            "bytes_total": bytes_tot,
            "coll_bytes_total": coll_tot,
        },
        "roofline": _roofline(terms),
        "dominant": dominant_term(terms),
        "model_flops": mf,
        "useful_ratio": mf["spec"] / max(flops_tot, 1.0),
        "elapsed_s": time.time() - t0,
    }


# --------------------------------------------------------------------------
# CLI
# --------------------------------------------------------------------------
def all_cells():
    for arch in ARCH_IDS:
        for shape_name in SHAPES:
            yield arch, shape_name
    yield KNN_ARCH, "knn_1M"


def cell_path(out: str, arch: str, shape_name: str, multi_pod: bool) -> str:
    tag = "multi" if multi_pod else "single"
    return os.path.join(out, f"{arch}__{shape_name}__{tag}.json")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--jobs", type=int, default=1)
    ap.add_argument("--no-calibrate", action="store_true")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    if not args.all:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape (or --all)")
        for mp in meshes:
            res = run_cell(args.arch, args.shape, mp, calibrate=not args.no_calibrate)
            tag = "multi" if mp else "single"
            path = cell_path(args.out, args.arch, args.shape, mp)
            with open(path, "w") as f:
                json.dump(res, f, indent=1)
            print(json.dumps(res, indent=1)[:2000])
            if res.get("supported"):
                print(f"[dryrun] {args.arch} x {args.shape} ({tag}-pod) "
                      f"dominant={res['dominant']} "
                      f"mem/slot={res['memory']['peak_bytes'] / 1e9:.2f} GB "
                      f"count+analysis={res['elapsed_s']:.1f}s", flush=True)
        return

    # --all: fan out one subprocess per cell (isolation + parallelism)
    jobs = []
    for arch, shape_name in all_cells():
        for mp in meshes:
            tag = "multi" if mp else "single"
            if os.path.exists(cell_path(args.out, arch, shape_name, mp)) and not args.force:
                continue
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", arch, "--shape", shape_name, "--out", args.out]
            if mp:
                cmd.append("--multi-pod")
            if args.no_calibrate:
                cmd.append("--no-calibrate")
            jobs.append((arch, shape_name, tag, cmd))

    running = []
    failures = []
    while jobs or running:
        while jobs and len(running) < args.jobs:
            arch, shape_name, tag, cmd = jobs.pop(0)
            print(f"[dryrun] start {arch} x {shape_name} ({tag})", flush=True)
            pr = subprocess.Popen(cmd, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
            running.append((arch, shape_name, tag, pr))
        time.sleep(1.0)
        still = []
        for arch, shape_name, tag, pr in running:
            if pr.poll() is None:
                still.append((arch, shape_name, tag, pr))
            elif pr.returncode != 0:
                err = pr.stderr.read().decode()[-2000:]
                failures.append((arch, shape_name, tag, err))
                print(f"[dryrun] FAIL {arch} x {shape_name} ({tag}):\n{err}", flush=True)
            else:
                print(f"[dryrun] done {arch} x {shape_name} ({tag})", flush=True)
        running = still
    if failures:
        print(f"[dryrun] {len(failures)} failures")
        sys.exit(1)
    print("[dryrun] all cells complete")


if __name__ == "__main__":
    main()
