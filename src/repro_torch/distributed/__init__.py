"""repro_torch.distributed — multi-device kNN over device slots.

Counterpart of ``repro.distributed``: the paper's multi-GPU query chunking
(``sharded``), one tree per slot over shards of the reference set
(``forest``), resident shards with query blocks ringed (``ring_knn``), and
the mutable forest's placement and workers (``dynamic_shards``).  One
process drives every slot: a thread and, on CUDA, a stream per slot
(``slots``).  ``mesh`` lays slots out as a named mesh (``SlotMesh``) for
the language model across slots, with placement by spec and the
collectives between slots.
"""

from repro_torch.distributed.dynamic_shards import (
    DeviceFanout,
    DrainTimeout,
    MergeRetryExhausted,
    MergeWorker,
    ShardPlacer,
    preview_rung_placement,
)
from repro_torch.distributed.mesh import SlotMesh
from repro_torch.distributed.forest import build_forest, forest_knn, stack_forest
from repro_torch.distributed.ring_knn import ring_knn_brute, ring_shards
from repro_torch.distributed.sharded import MultiDeviceTrees, multi_device_query

__all__ = [
    "SlotMesh",
    "ring_knn_brute",
    "ring_shards",
    "forest_knn",
    "build_forest",
    "stack_forest",
    "MultiDeviceTrees",
    "multi_device_query",
    "DeviceFanout",
    "DrainTimeout",
    "MergeRetryExhausted",
    "MergeWorker",
    "ShardPlacer",
    "preview_rung_placement",
]
