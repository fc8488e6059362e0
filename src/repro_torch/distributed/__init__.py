"""repro_torch.distributed — the mutable forest's placement and workers.

Counterpart of the part of ``repro.distributed`` that the ``dynamic``
engine needs (``dynamic_shards.py``).  The multi-device engines
(``sharded``, ``forest``, ``ring_knn``) are ROADMAP Queue 1 item 18.
"""

from repro_torch.distributed.dynamic_shards import (
    DeviceFanout,
    DrainTimeout,
    MergeRetryExhausted,
    MergeWorker,
    ShardPlacer,
    preview_rung_placement,
)

__all__ = [
    "DeviceFanout",
    "DrainTimeout",
    "MergeRetryExhausted",
    "MergeWorker",
    "ShardPlacer",
    "preview_rung_placement",
]
