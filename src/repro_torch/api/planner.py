"""Topology/memory-aware query planner (counterpart of ``repro.api.planner``).

Planning rules (numbering of ``docs/API.md``):
  1. an explicit ``engine=`` request is honored (parameters still filled);
  2. small jobs take ``brute``, unless a tree parameter was pinned;
  3. more than one device slot => ``forest`` (one tree per slot over equal
     shards, §3.2's scale-out) when n splits into the shard count (the
     slot count unless pinned) with at least max(2k, 2) points a shard,
     the shard's slab fits the budget and no ``n_chunks`` > 1 is pinned;
     else ``sharded`` (the paper's query chunking over replicated trees,
     which takes any n and streams chunks);
  4. under a ``memory_budget`` the slab precision is decided first
     (fp32 -> fp16 -> int8, the first whose codes plus dequantize metadata
     fit device-resident; int8 when none does), for the engines whose leaf
     slabs live in a ``ChunkedLeafStore`` (``PRECISION_ENGINES``); the
     others keep fp32 arrays;
  5. a budget below the resident bytes => ``chunked`` with the smallest N
     such that TWO chunk buffers fit (§3's double-buffered streaming);
     a pinned ``host`` or ``streaming`` engine streams by the same rule;
  6. otherwise ``chunked`` with N=1, the device-resident workflow.

``mutable=True`` plans the ``dynamic`` engine (the logarithmic-method
forest of ``core/dynamic.py``) on one device or several: its
rebuild-vs-merge crossover (``Plan.crossover_batch``), background carry
merges (``Plan.merge_async``, on unless pinned off) and, on more than one
device, the rung placement preview go into ``Plan.reasons``.  The
crossover is the reference's model, ``n / levels``: the reference's
measured crossover (its ``BENCH_dynamic.json``) was not taken on this
hardware and is not read.

``op`` (the primary operation, ``IndexSpec.op``) restricts the choice to
engines declaring it in ``EngineCaps.ops``: a pinned engine that lacks it
raises, an automatic choice that lacks it is rerouted to ``chunked``, and
``mutable=True`` with a dual-tree op is a contradiction (the mutable
engine is knn-only).  ``jit``, ``host`` and ``kdtree`` are taken only when
pinned, as in the reference.

Without a ``memory_budget`` the reference plans N=1 whatever the device
holds.  On CUDA the port reads each slot's free device memory
(``torch.cuda.mem_get_info``, shared by the slots on one card) and, when
the leaf structure would not fit in half of it, streams chunks under that
implicit budget (rule 5); the precision stays fp32 because no budget was
asked for.

MEASURED-COST CALIBRATION (the reference's): pass a ``Calibration``
(host->device copy rate, the fused round's cost, per-engine q/s, the
dynamic engine's measured crossover) and decisions become calibrated: the
single-device engine choice compares measured q/s, the chunk-visit
starvation deadline follows the copy-cost / round-cost ratio, the chunk
note gives the predicted copy time, and a measured crossover replaces the
dynamic engine's model.  Every calibrated decision lands in
``Plan.reasons`` with the numbers it used.  ``Calibration.load`` reads
only the port's own files (``BENCH_torch_copy_cost.json``,
``BENCH_torch_engine.json``, ``BENCH_torch_dynamic.json``), never the
reference's ``BENCH_*.json``, which were measured on other hardware;
``Calibration.refresh`` measures the copy rate on the card inline.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import time
import warnings
from typing import Any, Mapping, Optional, Sequence, Tuple

import torch

from repro_torch.core.chunked_jit import DEFAULT_STARVATION_DEADLINE
from repro_torch.core.quantize import BYTES_PER_ELEM, PRECISIONS
from repro_torch.core.toptree import default_buffer_size, suggest_height

__all__ = [
    "Plan",
    "plan",
    "BudgetError",
    "estimate_slab_bytes",
    "estimate_meta_bytes",
    "chunked_resident_bytes",
    "default_devices",
    "Calibration",
    "BRUTE_N_MAX",
    "BRUTE_WORK_MAX",
    "CALIBRATION_STALE_S",
    "PRECISION_ENGINES",
    "CHUNK_ENGINES",
]


class BudgetError(ValueError):
    """Raised under ``IndexSpec(strict_budget=True)`` when no plan fits the
    ``memory_budget``."""


BRUTE_N_MAX = 2048
BRUTE_WORK_MAX = 1 << 21
# Calibration measurements older than this are STALE: the planner still
# uses them (measured-but-old usually beats rule-based) but warns and
# records the staleness in Plan.reasons so decisions stay auditable.
CALIBRATION_STALE_S = 7 * 24 * 3600.0
# the port's own calibration files (Calibration.load); the reference's
# BENCH_copy_cost.json / BENCH_engine.json / BENCH_dynamic.json hold
# another machine's numbers and are never read
COPY_COST_FILE = "BENCH_torch_copy_cost.json"
ENGINE_FILE = "BENCH_torch_engine.json"
DYNAMIC_FILE = "BENCH_torch_dynamic.json"
# engines whose leaf slabs live in a ChunkedLeafStore honor a precision
# choice (rule 4; the dynamic forest's tree shards); those with one store
# stream its chunks under a budget (rule 5; the forest sizes each shard's)
PRECISION_ENGINES = ("chunked", "host", "streaming", "sharded", "dynamic")
CHUNK_ENGINES = ("chunked", "host", "streaming", "sharded")
_F32 = 4
# share of the free device memory the leaf structure may take when the
# caller gives no budget: the round state, work plan and merge buffers of a
# query batch live beside it
_IMPLICIT_BUDGET_SHARE = 0.5


def default_devices() -> Tuple[torch.device, ...]:
    """``IndexSpec.devices=None``: every visible CUDA device, one slot each
    (``kernels/ops.py::visible_devices``), or raise without a card."""
    from repro_torch.kernels.ops import visible_devices

    return visible_devices()


def _round_up(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


def _pad_dims(n, d, height, leaf_pad_multiple, d_pad_multiple):
    n_leaves = 1 << height
    leaf_pad = max(_round_up(-(-n // n_leaves), leaf_pad_multiple), leaf_pad_multiple)
    d_pad = max(_round_up(d, d_pad_multiple), d_pad_multiple)
    return n_leaves, leaf_pad, d_pad


def estimate_slab_bytes(
    n: int, d: int, height: int, *, leaf_pad_multiple: int = 8,
    d_pad_multiple: int = 1, precision: str = "fp32",
) -> int:
    """Device bytes of the padded leaf structure at tree height ``height``
    (2**h leaves of ceil(n / 2**h) points, rows padded like
    ``build_top_tree``).  The port stores features unpadded
    (``d_pad_multiple=1``; the kernel pads rows itself), where the
    reference pads them to a multiple of 8."""
    n_leaves, leaf_pad, d_pad = _pad_dims(n, d, height, leaf_pad_multiple, d_pad_multiple)
    return n_leaves * leaf_pad * d_pad * BYTES_PER_ELEM[precision]


def estimate_meta_bytes(
    n: int, d: int, height: int, *, leaf_pad_multiple: int = 8,
    d_pad_multiple: int = 1, precision: str = "fp32",
) -> int:
    """Device bytes of a quantized store's dequantize metadata (0 for fp32):
    the bit-packed dead mask, plus per-leaf scale/offset for int8."""
    if precision == "fp32":
        return 0
    n_leaves, leaf_pad, d_pad = _pad_dims(n, d, height, leaf_pad_multiple, d_pad_multiple)
    dead = -(-leaf_pad // 8)
    if precision == "fp16":
        return n_leaves * dead
    return n_leaves * (2 * d_pad * _F32 + dead)


def chunked_resident_bytes(plan) -> int:
    """Device bytes of a chunk-streamed leaf structure: two chunks of
    ceil(n_leaves/N) leaf slabs, plus any dequantize metadata."""
    meta = estimate_meta_bytes(plan.n, plan.d, plan.height, precision=plan.precision)
    if plan.n_chunks <= 1:
        return plan.slab_bytes + meta
    n_leaves = 1 << plan.height
    leaf_bytes = plan.slab_bytes // n_leaves
    return 2 * (-(-n_leaves // plan.n_chunks)) * leaf_bytes + meta


def _clamp_height(n: int, k: int, height: Optional[int]) -> Tuple[int, Tuple[str, ...]]:
    reasons = ()
    if height is not None:
        return int(height), reasons
    h = suggest_height(n)
    # keep mean leaf >= k so one leaf scan can yield k candidates
    while h > 1 and (n >> h) < max(2, k):
        h -= 1
        reasons = (f"height lowered to {h}: leaves must hold >= k={k} points",)
    return h, reasons


def _probe_h2d(
    sizes_mb: Tuple[float, float] = (1.0, 8.0), repeats: int = 3, device=None
) -> Tuple[float, float]:
    """Two-point host->device copy fit: (bandwidth GB/s, fixed latency s).

    The median of ``repeats`` synchronized copies of pageable host memory
    to ``device`` (default cuda:0) at two sizes, solved for slope
    (bandwidth) and intercept (per-transfer latency)."""
    dev = torch.device(device) if device is not None else torch.device("cuda", 0)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda *a: None)
    points = []
    for mb in sizes_mb:
        nbytes = int(mb * (1 << 20))
        host = torch.zeros(nbytes // 4, dtype=torch.float32)
        host.to(dev, copy=True)     # warm the path
        sync(dev)
        ts = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            host.to(dev, copy=True)
            sync(dev)
            ts.append(time.perf_counter() - t0)
        points.append((float(nbytes), sorted(ts)[len(ts) // 2]))
    (b0, t0), (b1, t1) = points
    slope = max((t1 - t0) / max(b1 - b0, 1.0), 1e-15)
    intercept = max(t0 - slope * b0, 0.0)
    return 1.0 / (slope * 1e9), intercept


@dataclasses.dataclass(frozen=True)
class Calibration:
    """Measured machine numbers the planner may substitute for its rules.

    ``Calibration.load()`` assembles one from whichever of the port's
    calibration files exist (``BENCH_torch_copy_cost.json``: H2D rate and
    the fused round's cost; ``BENCH_torch_engine.json``: per-engine q/s;
    ``BENCH_torch_dynamic.json``: the dynamic engine's build rate and
    crossover; the reference's keys), ``refresh()`` measures the copy rate
    inline, and a caller may build one from its own measurements.  All
    fields optional: a partial calibration informs only the decisions it
    has numbers for.
    """

    h2d_gbps: Optional[float] = None       # host->device copy bandwidth
    h2d_latency_s: float = 0.0             # fixed per-transfer cost
    round_s: Optional[float] = None        # one fused round, reference shape
    engine_qps: Mapping[str, float] = dataclasses.field(default_factory=dict)
    build_pps: Optional[float] = None      # static index build, points/sec
    dynamic_crossover: Optional[int] = None  # measured batch size beyond
                                           # which rebuild-from-scratch beats
                                           # batch-dynamic merge
    dynamic_measured: bool = False         # True when the dynamic bench ran:
                                           # tells "measured: no crossover in
                                           # range" (crossover None) from
                                           # "never measured"
    age_s: Optional[float] = None          # seconds since the OLDEST source
                                           # file was measured; None = unknown
    slow_age_s: Optional[float] = None     # seconds since the oldest SLOW
                                           # field (round cost, engine q/s)
                                           # was measured: the inline H2D
                                           # probe cannot refresh these, so
                                           # their staleness survives refresh
    source: str = ""

    @property
    def stale(self) -> bool:
        """True when the oldest source measurement has outlived
        ``CALIBRATION_STALE_S``: plan() warns and records it in reasons."""
        return self.age_s is not None and self.age_s > CALIBRATION_STALE_S

    @property
    def slow_stale(self) -> bool:
        """True when the slow fields (round cost, engine q/s) have outlived
        the staleness window; ``refresh()`` carries ``slow_age_s``."""
        return self.slow_age_s is not None and self.slow_age_s > CALIBRATION_STALE_S

    def chunk_copy_s(self, chunk_bytes: int) -> Optional[float]:
        """Predicted seconds to stream one chunk slab host->device."""
        if self.h2d_gbps is None or self.h2d_gbps <= 0:
            return None
        return self.h2d_latency_s + chunk_bytes / (self.h2d_gbps * 1e9)

    @classmethod
    def refresh(cls, base: Optional["Calibration"] = None, device=None) -> "Calibration":
        """Re-run the cheap copy-cost probe inline on ``device`` (default
        cuda:0) and fold the fresh H2D numbers over ``base`` (keeping its
        engine q/s etc., and its ``slow_age_s``)."""
        gbps, latency_s = _probe_h2d(device=device)
        base = base if base is not None else cls()
        src = "inline-refresh" if not base.source else base.source + "+inline-refresh"
        return dataclasses.replace(
            base, h2d_gbps=gbps, h2d_latency_s=latency_s, age_s=0.0,
            slow_age_s=base.slow_age_s, source=src,
        )

    @classmethod
    def load(cls, root: Optional[str] = None) -> Optional["Calibration"]:
        """Assemble from the port's calibration files under ``root``
        (default: the checkout this package sits in).  Returns None when
        none exists: callers then plan by rule.  The age is the files'
        modification time."""
        if root is None:
            root = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "..", ".."))
        h2d_gbps, h2d_latency_s, round_s = None, 0.0, None
        build_pps, dynamic_crossover = None, None
        engine_qps: dict = {}
        sources, mtimes, slow_mtimes = [], [], []
        cc = os.path.join(root, COPY_COST_FILE)
        if os.path.exists(cc):
            with open(cc) as f:
                data = json.load(f)
            h2d_gbps = data.get("h2d_gbps")
            h2d_latency_s = data.get("h2d_latency_s", 0.0)
            round_s = data.get("round_s")
            sources.append(COPY_COST_FILE)
            mtimes.append(os.path.getmtime(cc))
            if round_s is not None:
                slow_mtimes.append(os.path.getmtime(cc))
        eb = os.path.join(root, ENGINE_FILE)
        if os.path.exists(eb):
            with open(eb) as f:
                data = json.load(f)
            m = data.get("shape", {}).get("m")
            for eng, key in (("chunked", "chunked_s"), ("host", "host_s")):
                qps = data.get(f"{eng}_qps")
                if qps is None and m and data.get(key):
                    qps = m / data[key]
                if qps:
                    engine_qps[eng] = float(qps)
            sources.append(ENGINE_FILE)
            mtimes.append(os.path.getmtime(eb))
            if engine_qps:
                slow_mtimes.append(os.path.getmtime(eb))
        db = os.path.join(root, DYNAMIC_FILE)
        dynamic_measured = False
        if os.path.exists(db):
            with open(db) as f:
                data = json.load(f)
            build_pps = data.get("build_pps")
            dynamic_crossover = data.get("crossover_batch")
            dynamic_measured = True
            sources.append(DYNAMIC_FILE)
            mtimes.append(os.path.getmtime(db))
        if not sources:
            return None
        now = time.time()
        return cls(
            h2d_gbps=h2d_gbps, h2d_latency_s=h2d_latency_s, round_s=round_s,
            engine_qps=engine_qps, build_pps=build_pps,
            dynamic_crossover=dynamic_crossover, dynamic_measured=dynamic_measured,
            age_s=max(0.0, now - min(mtimes)),
            slow_age_s=max(0.0, now - min(slow_mtimes)) if slow_mtimes else None,
            source="+".join(sources),
        )


@dataclasses.dataclass(frozen=True)
class Plan:
    """A fully-resolved execution plan (every engine parameter pinned)."""

    engine: str
    height: int
    n: int = 0
    d: int = 0
    n_chunks: int = 1
    n_shards: int = 1
    n_devices: int = 1
    buffer_size: int = 4096
    fetch_m: int = 40960     # host loop: queries fetched per iteration
    tile_q: int = 128
    backend: str = "auto"
    slab_bytes: int = 0
    resident_bytes: int = 0
    memory_budget: Optional[int] = None
    precision: str = "fp32"
    over_budget: bool = False
    starvation_deadline: int = DEFAULT_STARVATION_DEADLINE
    calibrated: bool = False     # True when a Calibration informed decisions
    crossover_batch: Optional[int] = None  # dynamic: insert batches at or
                                 # above this flatten the forest
    merge_async: bool = False    # dynamic: carry merges on a background worker
    reasons: Tuple[str, ...] = ()

    def replace(self, **kw) -> "Plan":
        return dataclasses.replace(self, **kw)


def _implicit_budget(devices: Sequence[Any]) -> Tuple[Optional[int], str]:
    """Per slot, half the free memory of its CUDA device shared by the
    device's slots (the least over the slots), or None off CUDA."""
    cuda = [torch.device(d) for d in devices
            if isinstance(d, torch.device) and d.type == "cuda"]
    if not cuda or len(cuda) != len(devices):
        return None, ""
    notes, budget = [], None
    for dev in dict.fromkeys(cuda):
        free, total = torch.cuda.mem_get_info(dev)
        slots = cuda.count(dev)
        share = int(free * _IMPLICIT_BUDGET_SHARE) // slots
        budget = share if budget is None else min(budget, share)
        notes.append(f"{dev} has {free}B free of {total}B"
                     + (f" for {slots} slots" if slots > 1 else ""))
    return budget, (
        f"no memory_budget: {'; '.join(notes)}; the leaf structure may take "
        f"{budget}B of it per slot"
    )


def plan(
    n: int,
    d: int,
    m: Optional[int] = None,
    k: int = 10,
    devices: Optional[Sequence[Any]] = None,
    memory_budget: Optional[int] = None,
    *,
    engine: Optional[str] = None,
    height: Optional[int] = None,
    n_chunks: Optional[int] = None,
    n_shards: Optional[int] = None,
    buffer_size: Optional[int] = None,
    tile_q: int = 128,
    backend: str = "auto",
    precision: Optional[str] = None,
    strict_budget: bool = False,
    op: str = "knn",
    mutable: Optional[bool] = None,
    merge_async: Optional[bool] = None,
    calibration: Optional[Calibration] = None,
) -> Plan:
    """Pick an engine + parameters for (n, d) references and (m, k) queries.

    ``devices`` (the device slots; one device may repeat) defaults to every
    visible CUDA device (raises without a card); ``memory_budget`` is
    per-slot bytes for the leaf structure.  ``calibration`` substitutes
    measured numbers for the rules where it has them (``Calibration``);
    the string ``"refresh"`` loads the port's calibration files and, when
    they are missing or stale, measures the copy rate inline on the first
    slot's device.  Every decision is recorded in ``Plan.reasons``.
    """
    if n < 1 or d < 1:
        raise ValueError(f"need n >= 1, d >= 1; got n={n} d={d}")
    if k > n:
        raise ValueError(f"k={k} > n={n}")
    from repro_torch.api.engine import KNOWN_OPS, available_engines, get_engine

    if op not in KNOWN_OPS:
        raise ValueError(f"unknown op {op!r}; known: {sorted(KNOWN_OPS)}")
    if engine is not None and op != "knn":
        # a pinned engine that does not declare the op is a contradiction,
        # not a reroute opportunity
        caps = get_engine(engine).caps
        if op not in caps.ops:
            raise ValueError(
                f"op={op!r} but pinned engine {engine!r} does not declare "
                f"it (caps.ops={sorted(caps.ops)}); unpin the engine or "
                f"pick one of {sorted(available_engines(op=op))}"
            )
    if mutable and op != "knn":
        raise ValueError(
            f"op={op!r} with mutable=True: the mutable engine does not "
            f"declare it (caps.ops); declaring engines: "
            f"{sorted(available_engines(op=op))}"
        )
    if mutable and engine is not None and not get_engine(engine).caps.mutable:
        raise ValueError(
            f"mutable=True but pinned engine {engine!r} declares "
            "caps.mutable=False; unpin the engine or pick a mutable one "
            "(e.g. 'dynamic')"
        )
    if mutable and engine is None:
        engine = "dynamic"
    if devices is None:
        devices = default_devices()
    p = max(1, len(devices))
    reasons: list = []

    if isinstance(calibration, str):
        if calibration != "refresh":
            raise ValueError(
                f"calibration={calibration!r}: pass a Calibration, None, "
                "or the string 'refresh'"
            )
        loaded = Calibration.load()
        if loaded is None or loaded.stale:
            first = devices[0] if devices else None
            calibration = Calibration.refresh(
                loaded, device=first if isinstance(first, torch.device) else None)
            reasons.append(
                "calibration auto-refresh: "
                + ("no bench files found" if loaded is None
                   else f"sources {loaded.age_s / 86400.0:.1f}d old")
                + f"; inline H2D probe measured {calibration.h2d_gbps:.2f}"
                f"GB/s + {calibration.h2d_latency_s * 1e6:.0f}us/transfer "
                f"({calibration.source})"
            )
        else:
            calibration = loaded

    if calibration is not None and calibration.stale:
        age_d = calibration.age_s / 86400.0
        warnings.warn(
            f"planner calibration is {age_d:.1f} days old "
            f"(source: {calibration.source}); re-measure it on this machine "
            f"({COPY_COST_FILE}, {ENGINE_FILE})",
            stacklevel=2,
        )
        reasons.append(
            f"calibration stale: oldest source measured {age_d:.1f}d ago "
            f"({calibration.source}); using it, but numbers may have drifted"
        )

    h, h_reasons = _clamp_height(n, k, height)
    reasons.extend(h_reasons)
    b = int(buffer_size) if buffer_size is not None else default_buffer_size(h)
    slab32 = estimate_slab_bytes(n, d, h)

    def footprint(prec: str) -> int:
        return estimate_slab_bytes(n, d, h, precision=prec) + estimate_meta_bytes(
            n, d, h, precision=prec
        )

    # -- rule 4: precision against the budget ------------------------------
    if precision is not None:
        if precision not in PRECISIONS:
            raise ValueError(f"precision={precision!r} not in {PRECISIONS}")
        prec = precision
        reasons.append(
            f"precision {prec} pinned by caller: leaf slabs "
            f"{footprint(prec)}B ({slab32}B at fp32)"
        )
    elif memory_budget is None:
        prec = "fp32"
        reasons.append(
            "precision fp32: no memory_budget given, nothing to trade "
            "capacity against"
        )
    else:
        for cand in PRECISIONS:
            if footprint(cand) <= memory_budget:
                prec = cand
                if cand == "fp32":
                    reasons.append(
                        f"precision fp32: slab {slab32}B fits budget "
                        f"{memory_budget}B at full precision"
                    )
                else:
                    reasons.append(
                        f"precision {cand}: fp32 slab {slab32}B exceeds "
                        f"budget {memory_budget}B but {cand} "
                        f"({footprint(cand)}B incl. dequantize meta) fits "
                        "device-resident; candidates re-ranked exactly in fp32"
                    )
                break
        else:
            prec = "int8"
            reasons.append(
                f"precision int8: no precision fits budget {memory_budget}B "
                f"resident (int8 needs {footprint('int8')}B); int8 "
                "maximizes points per streamed byte, chunk-streaming covers "
                "the rest"
            )

    slab = estimate_slab_bytes(n, d, h, precision=prec)
    meta = estimate_meta_bytes(n, d, h, precision=prec)
    base = dict(
        height=h, n=n, d=d, n_devices=p, buffer_size=b, fetch_m=10 * b,
        tile_q=tile_q, backend=backend, slab_bytes=slab,
        memory_budget=memory_budget,
    )

    def chunks_for_budget(budget: Optional[int]) -> Tuple[int, str, bool]:
        if budget is None or slab + meta <= budget:
            return 1, "leaf structure fits device memory: device-resident (N=1)", False
        n_leaves = 1 << h
        # two chunk buffers (plus dequantize metadata) must fit, at leaf
        # granularity: a chunk holds ceil(n_leaves/N) leaf slabs
        leaf_bytes = slab // n_leaves
        c_max = (budget - meta) // max(1, 2 * leaf_bytes)
        nc = min(max(2, -(-n_leaves // c_max)), n_leaves) if c_max >= 1 else n_leaves
        resident = 2 * (-(-n_leaves // nc)) * leaf_bytes + meta
        note = (
            f"slab {slab}B > budget {budget}B at precision {prec}: "
            f"stream in N={nc} chunks (2 buffers resident = {resident}B)"
        )
        over = resident > budget
        if over:
            note += (
                f" [over budget: even N={nc} (one leaf per chunk) holds "
                f"{resident}B resident — budget is below the 2-chunk floor]"
            )
        if calibration is not None:
            copy_s = calibration.chunk_copy_s((resident - meta) // 2)
            if copy_s is not None:
                note += (
                    f"; calibrated chunk copy ~{copy_s * 1e3:.2f}ms at "
                    f"{calibration.h2d_gbps:.1f}GB/s"
                )
                if calibration.round_s:
                    note += f" vs fused round ~{calibration.round_s * 1e3:.2f}ms"
        return nc, note, over

    def calibrated_deadline() -> Tuple[int, Optional[str]]:
        """Starvation deadline (rounds a pending chunk may be skipped) from
        the measured copy-cost / round-cost ratio: when slab copies dominate
        a round, let cold chunks wait longer so each visit is denser; when
        rounds dominate, visit promptly."""
        if calibration is None:
            return DEFAULT_STARVATION_DEADLINE, None
        n_leaves = 1 << h
        nc_cand = n_chunks if n_chunks else 2
        chunk_bytes = (-(-n_leaves // max(1, nc_cand))) * (slab // n_leaves)
        copy_s = calibration.chunk_copy_s(chunk_bytes)
        if copy_s is None or not calibration.round_s:
            return DEFAULT_STARVATION_DEADLINE, None
        ratio = copy_s / max(calibration.round_s, 1e-9)
        dl = int(min(16, max(1, round(ratio))))
        src = f"; {calibration.source}" if calibration.source else ""
        return dl, (
            f"calibrated starvation deadline {dl} rounds: chunk copy "
            f"~{copy_s * 1e3:.2f}ms / round ~{calibration.round_s * 1e3:.2f}ms "
            f"(ratio {ratio:.2f}{src})"
        )

    tree_requested = height is not None or n_chunks is not None or buffer_size is not None
    small_job = n <= BRUTE_N_MAX or k * 4 > n or (m is not None and m * n <= BRUTE_WORK_MAX)

    def resident_for(name: str, nc: int = 1, ns: int = 1) -> int:
        probe = Plan(engine=name, n_chunks=nc, n_shards=ns, resident_bytes=slab,
                     reasons=(), **base)
        return get_engine(name).resident_bytes(probe)

    brute_fits = memory_budget is None or resident_for("brute") <= memory_budget
    if engine is None:
        if not tree_requested and small_job and brute_fits:
            engine = "brute"
            reasons.append(
                f"n={n} <= {BRUTE_N_MAX}, k~O(n), or m*n <= "
                f"{BRUTE_WORK_MAX}: one fused brute scan beats tree build "
                "+ traversal"
            )
        elif p > 1:
            # a pinned shard count must itself divide n; otherwise the shard
            # count is the slot count
            shards = int(n_shards) if n_shards is not None else p
            per_shard = slab // max(1, shards)
            fits = memory_budget is None or per_shard <= memory_budget
            # a pinned n_chunks > 1 is an out-of-core constraint the forest's
            # device-resident shards cannot honor
            wants_chunks = n_chunks is not None and n_chunks > 1
            if n % shards == 0 and (n // shards) >= max(2 * k, 2) and fits and not wants_chunks:
                engine = "forest"
                reasons.append(
                    f"{p} devices visible and n % {shards} == 0: per-shard "
                    "buffer k-d trees + all-gather merge (paper §3.2 scale-out)"
                )
            else:
                engine = "sharded"
                if not fits:
                    why = (f"per-shard slab {per_shard}B exceeds budget "
                           f"{memory_budget}B (forest shards are device-resident)")
                elif wants_chunks:
                    why = (f"pinned n_chunks={n_chunks} requires chunk streaming, "
                           "which forest shards cannot do")
                else:
                    why = f"n={n} does not split into {shards} equal shards"
                reasons.append(
                    f"{p} devices visible but {why}: paper-faithful query "
                    "chunking over replicated trees"
                )
        elif calibration is not None and calibration.engine_qps:
            # calibrated single-device choice: measured q/s beats the rule,
            # among engines that can honor an out-of-core constraint
            candidates = {}
            for name, qps in calibration.engine_qps.items():
                try:
                    caps = get_engine(name).caps
                except KeyError:
                    continue
                if memory_budget is not None and not caps.out_of_core:
                    continue
                candidates[name] = qps
            if candidates:
                engine = max(candidates, key=candidates.get)
                measured = ", ".join(f"{e}={q:.0f} q/s" for e, q in sorted(candidates.items()))
                reasons.append(
                    f"1 device, calibrated engine choice ({measured}; "
                    f"{calibration.source}): {engine}"
                )
            else:
                engine = "chunked"
                reasons.append("1 device: chunk-streamed buffer k-d tree")
        else:
            engine = "chunked"
            reasons.append("1 device: chunk-streamed buffer k-d tree")
    get_engine(engine)   # raises for unknown / not-yet-ported engines

    # a non-kNN primary op: the engine must declare it (a pinned one was
    # checked above); an automatic choice that does not reroutes to
    # 'chunked', the dual tree over the same chunk-streamed leaf store
    if op != "knn":
        declaring = sorted(available_engines(op=op))
        if op in get_engine(engine).caps.ops:
            reasons.append(f"op={op!r} declared by engine {engine!r} (caps.ops)")
        else:
            reasons.append(
                f"op={op!r} not declared by auto choice {engine!r}; "
                f"rerouted to 'chunked' (declaring engines: {declaring})"
            )
            engine = "chunked"

    if engine not in PRECISION_ENGINES and prec != "fp32":
        reasons.append(
            f"precision request {prec} not applicable: engine {engine} "
            "stores fp32 reference arrays (no leaf slabs to quantize)"
        )
        prec = "fp32"
        base["slab_bytes"] = slab = estimate_slab_bytes(n, d, h)
        meta = 0

    over_budget = False
    over_detail = ""
    if engine in CHUNK_ENGINES:
        if n_chunks is None:
            budget = memory_budget
            if budget is None:
                budget, note = _implicit_budget(devices)
                if note:
                    reasons.append(note)
            n_chunks, note, over_budget = chunks_for_budget(budget)
            reasons.append(note)
            if over_budget:
                over_detail = note
        else:
            reasons.append(f"N={n_chunks} chunks pinned by caller")

    crossover = None
    do_merge_async = False
    if engine == "dynamic":
        crossover, note = _mutable_costing(n, calibration)
        reasons.append(note)
        # background staging unless pinned off: queries keep answering from
        # the pre-merge shards, only insert/query tail latency changes
        do_merge_async = True if merge_async is None else bool(merge_async)
        reasons.append(
            "carry merges offloaded to a background staging worker; queries "
            "answer from the pre-merge shards until the atomic swap "
            "(merge_async=True)" if do_merge_async else
            "carry merges run inline on the insert path (merge_async=False "
            "pinned by caller)"
        )
        if p > 1:
            from repro_torch.core.dynamic import DEFAULT_BASE_CAPACITY
            from repro_torch.distributed.dynamic_shards import preview_rung_placement

            preview = preview_rung_placement(
                n, base_capacity=min(b, DEFAULT_BASE_CAPACITY),
                brute_cutoff=BRUTE_N_MAX, n_devices=p)
            pv = ", ".join(f"rung {cap}->dev{slot}" for cap, slot in preview[:6])
            reasons.append(
                f"mutable multi-device: {p} devices; tree rungs placed "
                f"least-loaded (steady-state preview: {pv}), brute rungs pinned "
                "to dev0; per-device fan-out folds with the two-phase rank merge"
            )
        else:
            reasons.append(
                "1 device: dynamic forest runs single-device (placement and "
                "fan-out degenerate to the lead device)"
            )
        if memory_budget is not None and resident_for("dynamic", ns=p) > memory_budget:
            # each tree shard streams its leaf slabs within the budget; only a
            # budget below two leaf slabs of the largest shard cannot be met
            floor = 2 * max(1, slab // (1 << h)) + meta
            if floor > memory_budget:
                over_budget = True
                over_detail = (
                    f"memory_budget {memory_budget}B is below the dynamic "
                    f"forest's 2-leaf streaming floor {floor}B at precision {prec}"
                )
                reasons.append(over_detail + " [over budget]")
            else:
                reasons.append(
                    f"memory_budget {memory_budget}B below the dynamic forest's "
                    f"resident estimate {resident_for('dynamic', ns=p)}B: tree "
                    "shards chunk-stream their leaf slabs to stay inside the "
                    f"envelope (precision {prec})"
                )

    if (calibration is not None and calibration.slow_stale
            and engine in ("chunked", "host", "sharded", "streaming", "dynamic")):
        # the inline H2D refresh cannot re-measure these: disclose that the
        # deadline / engine-choice inputs are old
        reasons.append(
            "calibration stale: slow fields (round cost, engine q/s) "
            f"measured {calibration.slow_age_s / 86400.0:.1f}d ago and the "
            "inline H2D probe cannot refresh them; re-measure them on this "
            f"machine ({COPY_COST_FILE}, {ENGINE_FILE})"
        )

    if over_budget and strict_budget:
        raise BudgetError(
            f"strict_budget: no {engine} plan fits memory_budget="
            f"{memory_budget}B — {over_detail}"
        )
    nc = int(n_chunks) if n_chunks is not None else 1
    ns = int(n_shards) if n_shards is not None else (
        p if engine in ("forest", "sharded", "ring", "dynamic") else 1)
    deadline, dl_note = calibrated_deadline()
    if dl_note is not None and engine in CHUNK_ENGINES:
        reasons.append(dl_note)
    return Plan(
        engine=engine, n_chunks=nc, n_shards=ns,
        resident_bytes=resident_for(engine, nc, ns),
        starvation_deadline=deadline, calibrated=calibration is not None,
        precision=prec, over_budget=over_budget, crossover_batch=crossover,
        merge_async=do_merge_async, reasons=tuple(reasons), **base
    )


def _mutable_costing(n: int, calibration: Optional[Calibration] = None) -> Tuple[
        Optional[int], str]:
    """Rebuild-vs-merge crossover of the dynamic engine, the reference's
    model: a batch of b points absorbed by the carry chain costs ~b * levels
    point rebuilds, a flattening rebuild ~n + b; they cross at ~n / levels.
    A calibration with a measured crossover overrides the model (a measured
    None means batch-dynamic ingest won at every measured size: nothing is
    forced through a flattening rebuild); a measured build rate turns the
    model's ratios into seconds."""
    from repro_torch.core.dynamic import DEFAULT_BASE_CAPACITY

    levels = max(1, math.ceil(math.log2(max(2.0, n / DEFAULT_BASE_CAPACITY))))
    if calibration is not None and calibration.dynamic_measured:
        if calibration.dynamic_crossover:
            cx = int(calibration.dynamic_crossover)
            return cx, (
                f"mutable: dynamic engine; measured rebuild-vs-merge "
                f"crossover at batches >= {cx} points ({calibration.source})"
            )
        return None, (
            "mutable: dynamic engine; measured: batch-dynamic ingest won at "
            "every measured batch size, no flattening threshold pinned "
            f"({calibration.source})"
        )
    cx = max(DEFAULT_BASE_CAPACITY, n // levels)
    note = (
        f"mutable: dynamic engine; carry-chain merge touches a point <= "
        f"{levels}x vs full rebuild of {n}, modeled crossover at batches >= "
        f"{cx}"
    )
    if calibration is not None and calibration.build_pps:
        note += (
            f" (~{cx * levels / calibration.build_pps:.2f}s merge "
            f"~= {(n + cx) / calibration.build_pps:.2f}s rebuild at "
            f"{calibration.build_pps:.0f} pts/s)"
        )
    if calibration is None:
        note += f" (the model's: no crossover measured, no {DYNAMIC_FILE} given)"
    return cx, note
