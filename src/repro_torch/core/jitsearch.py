"""Work-plan construction: the sort-by-leaf that is the buffer structure.

Counterpart of ``repro.core.jitsearch._build_plan`` (the rest of that
module, the device-resident fixed point ``lazy_knn_jit``, is not ported
yet).  Queries bound for the same leaf become adjacent after a stable sort,
and each run of up to TQ of them becomes one work unit: a dense
[TQ x leaf] scan, which is the batching the paper's buffers exist to
create, expressed as sort + cumsum + scatter on the device.

The plan width is fixed by the shapes: at most ceil(m/TQ) full units plus
one partial unit per leaf, so W_max = ceil(m/TQ) + n_leaves, plus one dump
row that every retired query scatters into.
"""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["_build_plan"]

_BIG = 2**30


def _build_plan(
    leaf: torch.Tensor, tq: int, n_leaves: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """leaf: i32[m] target leaf per query, -1 for retired queries.

    Returns (unit_leaf i32[W+1], unit_query i32[W+1, TQ], n_units i32[]),
    dump row last.  Occupied units form the prefix [0, n_units); retired
    queries and empty slots hold -1 in ``unit_query``.
    """
    m = leaf.shape[0]
    dev = leaf.device
    w_max = (m + tq - 1) // tq + n_leaves

    key = torch.where(leaf < 0, _BIG, leaf.long())
    sl, order = torch.sort(key, stable=True)
    active = sl < _BIG
    ar = torch.arange(m, dtype=torch.int64, device=dev)
    prev = torch.cat([torch.full((1,), -7, dtype=sl.dtype, device=dev), sl[:-1]])
    newgrp = sl != prev
    group_start = torch.cummax(torch.where(newgrp, ar, 0), dim=0).values
    within = ar - group_start
    newunit = newgrp | (within % tq == 0)
    unit_id = torch.cumsum(newunit.to(torch.int64), dim=0) - 1
    unit_id = torch.where(active, torch.clamp(unit_id, max=w_max - 1), w_max)
    slot = within % tq
    n_units = torch.sum(active & newunit).to(torch.int32)

    # every query of one unit writes the same leaf id, and the dump row
    # only ever receives zeros / -1, so the duplicate writes are
    # deterministic
    unit_leaf = torch.zeros((w_max + 1,), dtype=torch.int32, device=dev)
    unit_leaf[unit_id] = torch.where(active, sl, 0).to(torch.int32)
    unit_query = torch.full((w_max + 1, tq), -1, dtype=torch.int32, device=dev)
    unit_query[unit_id, slot] = torch.where(active, order, -1).to(torch.int32)
    return unit_leaf, unit_query, n_units
