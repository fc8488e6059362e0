"""Ring kNN: reference shards resident on the device slots, query blocks
rotated around them.

Counterpart of ``repro.distributed.ring_knn``.  The paper (§3.2) hides
host->device chunk copies behind brute-force compute; here the reference
shards stay resident, one per slot, and it is the query blocks, far
smaller, that move: each step every slot scans its shard against the block
it holds, then hands the block and its running list to the next slot.
After P steps every block has met every shard.

The scan of a step is the leaf-scan kernel (``kernels/ops.py::
leaf_scan_units``): a shard is laid out as slabs of ``L_pad`` rows
(``RING_SLAB``, padded with ``PAD_COORD`` rows), and every (query tile,
slab) pair of the block is one work unit; the units' lists are merged into
the block's running list, where the reference scans with ``jnp`` tiles
(``_tile_merge``).  Like every engine of the port it is exact: the scan
keeps ``k + FP32_OVERFETCH`` candidates by the kernel's decomposed
distance, the lead slot re-ranks them by the direct fp32 form (their rows
gathered from the slots that own them), ``certify`` proves each row at
eps = 0, and unproven rows take fp32 brute force.  Equal distances go to
the lower id, so the answer does not depend on the slot count.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.brute import knn_brute
from repro_torch.core.lazysearch import FP32_OVERFETCH, certify
from repro_torch.distributed.dynamic_shards import DeviceFanout
from repro_torch.distributed.slots import hand_over, on_slot, run_on_slots, slot_streams
from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import INVALID_DIST, PAD_COORD, smallest_k

__all__ = ["RingShards", "ring_shards", "ring_knn_brute", "RING_SLAB", "RING_UNITS"]

RING_SLAB = 32768   # rows of a shard's slab: the kernel's L_pad
RING_UNITS = 4096   # work units (query tile x slab) per leaf-scan launch


def _round_up(x: int, mult: int) -> int:
    return -(-x // mult) * mult


@dataclasses.dataclass
class RingShards:
    """The reference set resident over the slots: slot ``s`` holds rows
    ``[s nb, (s + 1) nb)`` of the points (padded with PAD_COORD rows to
    ``P nb``) as ``slabs[s]`` f32[n_slabs, L_pad, d].  ``points`` (the
    caller's n rows, on the host) is the brute force's; ``x_norm_max``
    bounds their norms for ``certify``.  ``slot_seconds`` holds each slot's
    seconds in the last query; ``lock`` serializes queries."""

    slabs: List[torch.Tensor]
    points: np.ndarray
    nb: int
    l_pad: int
    tq: int
    backend: str
    x_norm_max: float
    devices: List[torch.device]
    streams: list
    fanout: DeviceFanout = dataclasses.field(default_factory=DeviceFanout)
    lock: threading.Lock = dataclasses.field(default_factory=threading.Lock)
    slot_seconds: Dict[int, float] = dataclasses.field(default_factory=dict)

    @property
    def n(self) -> int:
        return self.points.shape[0]

    @property
    def p(self) -> int:
        return len(self.slabs)


def ring_shards(points: np.ndarray, devices: Sequence, *, tile_q: int = 128,
                backend: str = "auto") -> RingShards:
    """Place ``points`` on the slots ``devices``, one equal shard each."""
    points = np.ascontiguousarray(points, np.float32)
    devs = [torch.device(d) for d in devices]
    n, d = points.shape
    p = len(devs)
    nb = _round_up(n, p) // p
    l_pad = min(RING_SLAB, _round_up(nb, 8))
    n_slabs = -(-nb // l_pad)
    padded = np.full((p, n_slabs * l_pad, d), np.float32(PAD_COORD))
    for s in range(p):
        rows = points[s * nb:(s + 1) * nb]
        padded[s, :rows.shape[0]] = rows
    be = kops.resolve_backend(backend, devs[0])
    streams = slot_streams(devs)
    slabs = []
    for s in range(p):
        with on_slot(streams[s]):
            slabs.append(torch.from_numpy(padded[s].reshape(n_slabs, l_pad, d)).to(devs[s]))
    for st in streams:
        if st is not None:
            st.synchronize()
    norms = np.sqrt(np.sum(points.astype(np.float64) ** 2, axis=1))
    return RingShards(slabs=slabs, points=points, nb=nb, l_pad=l_pad,
                      tq=kops.engine_tile_q(tile_q, be), backend=be,
                      x_norm_max=float(norms.max()), devices=devs, streams=streams)


def _scan_merge(ring: RingShards, s: int, q: torch.Tensor, run_d: torch.Tensor,
                run_i: torch.Tensor, k_eff: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Slot ``s`` scans its shard against the block ``q`` f32[mb, d] and
    merges the units' lists into the running list (f32 / i64 [mb, k_eff],
    ascending, global ids), a group of query tiles per launch.  Returns
    the new running list (new tensors: the old ones may be another slot's
    hand-over)."""
    slab = ring.slabs[s]
    dev = slab.device
    n_slabs, l_pad = slab.shape[0], slab.shape[1]
    kl = min(k_eff, l_pad)
    tq, mb = ring.tq, q.shape[0]
    n_tiles = -(-mb // tq)
    group = max(1, RING_UNITS // n_slabs)
    # shard row of each unit's first row; rows past the shard (a slab's
    # padding) get the id P nb, past every point, never another shard's
    first = torch.arange(n_slabs, device=dev, dtype=torch.int64)[:, None, None] * l_pad
    pad_id = ring.p * ring.nb
    out_d, out_i = [], []
    for t0 in range(0, n_tiles, group):
        g = min(group, n_tiles - t0)
        r0, r1 = t0 * tq, min(mb, (t0 + g) * tq)
        rows = torch.arange(r0, r0 + g * tq, device=dev, dtype=torch.int32).reshape(g, 1, tq)
        rows = torch.where(rows < mb, rows, -1)
        # unit (tile i, slab j) = row i * n_slabs + j
        unit_query = rows.expand(g, n_slabs, tq).reshape(g * n_slabs, tq).contiguous()
        unit_leaf = torch.arange(n_slabs, device=dev, dtype=torch.int32).repeat(g)
        n_units = torch.tensor([g * n_slabs], dtype=torch.int32, device=dev)
        nd, nli = kops.leaf_scan_units(q, slab, unit_leaf, unit_query, n_units, k=kl,
                                       backend=ring.backend)
        row = nli.reshape(g, n_slabs, tq, kl) + first
        gid = torch.where(row < ring.nb, row + s * ring.nb, pad_id).permute(0, 2, 1, 3)
        cd = nd.reshape(g, n_slabs, tq, kl).permute(0, 2, 1, 3).reshape(g * tq, n_slabs * kl)
        ci = gid.reshape(g * tq, n_slabs * kl)
        cd = torch.cat([run_d[r0:r1], cd[:r1 - r0]], dim=1)
        ci = torch.cat([run_i[r0:r1], ci[:r1 - r0]], dim=1)
        sd, sel = smallest_k(cd, k_eff)
        out_d.append(sd)
        out_i.append(torch.gather(ci, 1, sel))
    return torch.cat(out_d), torch.cat(out_i)


def _rerank(ring: RingShards, q: torch.Tensor, cand: torch.Tensor) -> torch.Tensor:
    """Direct fp32 squared distances of the candidates ``cand`` i64[m, k_eff]
    (global ids) to ``q`` on the lead slot, each candidate's row gathered by
    the slot that owns it; ids past the points (pad rows) get +inf."""
    lead, lead_st = ring.devices[0], ring.streams[0]
    with on_slot(lead_st):
        flat = cand.reshape(-1)
        rows = torch.zeros((flat.numel(), q.shape[1]), device=lead)
        owner = torch.where(flat < ring.n, torch.div(flat, ring.nb, rounding_mode="floor"), -1)
    for o in range(ring.p):
        with on_slot(lead_st):
            at = torch.nonzero(owner == o).flatten()
            local = flat[at] - o * ring.nb
        if at.numel() == 0:
            continue
        local = hand_over(local, lead_st, ring.devices[o], ring.streams[o])
        with on_slot(ring.streams[o]):
            x = ring.slabs[o].reshape(-1, q.shape[1])[local]
        x = hand_over(x, ring.streams[o], lead, lead_st)
        with on_slot(lead_st):
            rows[at] = x
    with on_slot(lead_st):
        diff = rows.reshape(cand.shape + (q.shape[1],)) - q[:, None, :]
        d2 = torch.sum(diff * diff, dim=-1)
        return torch.where(cand < ring.n, d2, torch.inf)


def ring_knn_brute(queries: np.ndarray, ring: RingShards, *, k: int
                   ) -> Tuple[np.ndarray, np.ndarray, int]:
    """Multi-slot exact kNN, the reference shards resident, the query
    blocks ringed.  ``queries`` f32[m, d] are padded with zero rows to a
    multiple of P and split into P contiguous blocks, block b starting on
    slot b.  Returns (dists f32[m, k] ascending Euclidean, ids i64[m, k],
    -1 past the points at +inf; the number of rows answered by brute
    force)."""
    queries = np.ascontiguousarray(queries, np.float32)
    m, d = queries.shape
    p, n = ring.p, ring.n
    k_eff = min(k + FP32_OVERFETCH, n)
    mb = -(-m // p)
    qpad = np.zeros((mb * p, d), np.float32)
    qpad[:m] = queries
    with ring.lock:
        blocks = []
        for b in range(p):
            with on_slot(ring.streams[b]):
                dev = ring.devices[b]
                blocks.append((kops.owned_tensor(qpad[b * mb:(b + 1) * mb], dev),
                               torch.full((mb, k_eff), INVALID_DIST, device=dev),
                               torch.full((mb, k_eff), -1, dtype=torch.int64, device=dev)))
        seconds = dict.fromkeys(range(p), 0.0)
        for t in range(p):
            # slot s holds block (s - t) mod p
            def step(s: int, t: int = t) -> None:
                b = (s - t) % p
                q, run_d, run_i = blocks[b]
                blocks[b] = (q,) + _scan_merge(ring, s, q, run_d, run_i, k_eff)

            for s, sec in run_on_slots(ring.fanout, ring.streams,
                                       {s: (lambda s=s: step(s)) for s in range(p)}).items():
                seconds[s] += sec
            if t + 1 < p:
                for b in range(p):
                    s = (b + t) % p
                    nxt = (s + 1) % p
                    blocks[b] = tuple(hand_over(x, ring.streams[s], ring.devices[nxt],
                                                ring.streams[nxt]) for x in blocks[b])
        ring.slot_seconds = seconds
        # every block's list to the lead slot (block b ended on slot b - 1)
        lead, lead_st = ring.devices[0], ring.streams[0]
        got = [tuple(hand_over(x, ring.streams[(b + p - 1) % p], lead, lead_st)
                     for x in blocks[b]) for b in range(p)]
        with on_slot(lead_st):
            q_all = torch.cat([g[0] for g in got])[:m]
            raw = torch.cat([g[1] for g in got])[:m]
            cand = torch.cat([g[2] for g in got])[:m]
            # equal distances to the lower id: candidates by id, then a
            # stable sort by the direct distance
            cand, _ = torch.sort(cand, dim=1)
        d2 = _rerank(ring, q_all, cand)
        with on_slot(lead_st):
            d2, order = torch.sort(d2, dim=1, stable=True)
            cand = torch.gather(cand, 1, order)
            dists = kops.sqrt(d2.clamp_min(0.0)).cpu().numpy()
            idx = cand.cpu().numpy()
            raw = raw.cpu().numpy()
    ok = np.ones(m, bool) if k_eff >= n else certify(
        queries, raw, dists, k, k_eff, eps=0.0, x_norm_max=ring.x_norm_max)
    dists, idx = dists[:, :k].copy(), idx[:, :k].copy()
    idx[~np.isfinite(dists)] = -1
    rows = np.nonzero(~ok)[0]
    if rows.size:
        dists[rows], idx[rows] = knn_brute(queries[rows], ring.points, k, device=lead)
    return dists.astype(np.float32), idx.astype(np.int64), int(rows.size)
