"""Roofline terms on an NVIDIA H100 SXM, and the collective bytes of a run.

Counterpart of ``repro.roofline.analysis``:

    compute term    = FLOPs / (cards * PEAK_FLOPS)
    memory term     = bytes / (cards * HBM_BW)
    collective term = collective_bytes / (cards * LINK_BW)

The reference parses the collectives out of XLA's optimized HLO.  The port
has no HLO: its collectives (``distributed/mesh.py``: ``all_sum``,
``all_gather``, ``reduce_scatter``, ``all_max``, ``reduce_to`` and their
autograd backwards) and the sharded train step's gradient reductions
(``training/step.py``) call ``record_collective`` once per collective, and
``count_collectives(slots)`` returns the ``CollectiveStats`` of what ran
inside it, by the reference's rules: operand bytes **per slot** by kind,
and the ring-model wire bytes.  A collective over a group of p slots is
counted once for each of its p slots (whatever copies the one-card
implementation makes: there a gather is views and ``.to``), and the totals
are divided by the mesh's slot count, so a program in which every slot
runs the same collectives reports what one slot runs, as the reference's
per-device HLO does.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Dict, Iterator, List

__all__ = ["HW", "collective_bytes", "count_collectives", "record_collective",
           "roofline_terms", "dominant_term", "CollectiveStats"]

# NVIDIA H100 SXM5 (80 GB HBM3) data-sheet peaks, per card, at its 700 W
# power limit; a card set below 700 W runs slower under load.
HW = {
    "peak_flops": 989e12,   # dense bf16 tensor-core FLOP/s (the compute term)
    "fp32_flops": 67e12,    # fp32 FLOP/s on the CUDA cores (the port's
                            # attention scores and values run FFMA in fp32)
    "hbm_bw": 3.35e12,      # HBM3 B/s
    "link_bw": 450e9,       # NVLink 4 B/s each way per card (900 GB/s both
                            # ways over its 18 links): the collective term
    "hbm_bytes": 80e9,      # device memory per card (the capacity check)
}

@dataclasses.dataclass
class CollectiveStats:
    per_op: Dict[str, int]          # op kind -> operand bytes (per slot)
    count: Dict[str, int]           # op kind -> collectives (per slot)
    total: int                      # Σ operand bytes (per slot)
    wire_ring: float                # ring-model wire bytes (per slot)

    def as_dict(self):
        return {
            "per_op": self.per_op,
            "count": self.count,
            "total": self.total,
            "wire_ring": self.wire_ring,
        }


class _Meter:
    """Sums over the slots of every collective recorded while active."""

    def __init__(self, slots: int):
        self.slots = max(1, int(slots))
        self.per_op: Dict[str, float] = {}
        self.count: Dict[str, float] = {}
        self.wire = 0.0

    def add(self, kind: str, operand: float, wire: float, p: int) -> None:
        self.per_op[kind] = self.per_op.get(kind, 0.0) + operand * p
        self.count[kind] = self.count.get(kind, 0.0) + p
        self.wire += wire * p

    def stats(self) -> CollectiveStats:
        def per_slot(v: float):
            x = v / self.slots
            return int(x) if float(x).is_integer() else x

        per_op = {k: per_slot(v) for k, v in self.per_op.items()}
        return CollectiveStats(per_op, {k: per_slot(v) for k, v in self.count.items()},
                               per_slot(sum(self.per_op.values())), self.wire / self.slots)


_METERS: List[_Meter] = []
_LOCK = threading.Lock()


def record_collective(kind: str, part_bytes: int, p: int) -> None:
    """One collective of ``kind`` over a group of ``p`` slots, each giving
    an operand of ``part_bytes``: for all-gather the slot's piece, for
    reduce-scatter and all-reduce its whole input.  The wire bytes follow
    the reference's ring model (``repro/roofline/analysis.py:92-123``)."""
    if p <= 1 or not _METERS:
        return
    if kind == "all-gather":
        wire = part_bytes * (p - 1)
    elif kind == "reduce-scatter":
        wire = part_bytes / p * (p - 1)
    elif kind == "all-reduce":
        wire = 2.0 * part_bytes * (p - 1) / p
    elif kind == "all-to-all":
        wire = part_bytes * (p - 1) / p
    elif kind == "collective-permute":
        wire = float(part_bytes)
    else:
        raise ValueError(f"unknown collective kind {kind!r}")
    with _LOCK:
        for m in _METERS:
            m.add(kind, float(part_bytes), float(wire), p)


@contextlib.contextmanager
def count_collectives(slots: int) -> Iterator[_Meter]:
    """Count the collectives run inside, per slot of a mesh of ``slots``:
    what it yields has ``stats()``, the ``CollectiveStats`` so far."""
    meter = _Meter(slots)
    with _LOCK:
        _METERS.append(meter)
    try:
        yield meter
    finally:
        with _LOCK:
            _METERS.remove(meter)


def collective_bytes(fn, slots: int) -> CollectiveStats:
    """The ``CollectiveStats`` of ``fn()`` run over a mesh of ``slots``
    (the reference's ``collective_bytes(hlo_text)``, measured by running)."""
    with count_collectives(slots) as c:
        fn()
    return c.stats()


def roofline_terms(
    total_flops: float,
    total_bytes: float,
    total_coll_bytes: float,
    chips: int,
) -> Dict[str, float]:
    """Three roofline terms in SECONDS, per card (totals are whole-job,
    divided over ``chips`` cards)."""
    return {
        "compute_s": total_flops / (chips * HW["peak_flops"]),
        "memory_s": total_bytes / (chips * HW["hbm_bw"]),
        "collective_s": total_coll_bytes / (chips * HW["link_bw"]),
    }


def dominant_term(terms: Dict[str, float]) -> str:
    return max(
        (("compute", terms["compute_s"]),
         ("memory", terms["memory_s"]),
         ("collective", terms["collective_s"])),
        key=lambda kv: kv[1],
    )[0]
