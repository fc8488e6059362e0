"""repro_torch.api — the kNN front door on PyTorch + CUDA.

    from repro_torch.api import KNNIndex

    index = KNNIndex.build(points)             # planner picks the engine
    dists, idx = index.query(queries, k=10)    # exact kNN

Counterpart of ``repro.api`` with the ``brute``, ``kdtree``, ``host``,
``chunked``, ``streaming``, ``jit`` and ``dynamic`` engines, the
multi-device ``sharded``, ``forest`` and ``ring``, the dual-tree ops
(``radius``, ``kde``, ``pair_count``) and snapshots (``KNNIndex.save`` /
``KNNIndex.load``, in the reference's format).  ``knn_brute`` is re-exported as the
ground-truth oracle, ``knn_round_cache_size`` counts the distinct
chunk-round shapes run and ``dualtree_cache_size`` the distinct
leaf-pair batch shapes.
"""

from repro_torch.api.engine import (
    KNOWN_OPS,
    Engine,
    EngineBase,
    EngineCaps,
    MutabilityError,
    OpUnsupported,
    StreamingUnsupported,
    available_engines,
    get_engine,
    register_engine,
)
from repro_torch.api.planner import (
    BudgetError,
    Plan,
    estimate_meta_bytes,
    estimate_slab_bytes,
    plan,
)
from repro_torch.api.spec import (
    IndexSpec,
    QueryResult,
    RadiusResult,
    SearchStats,
    StatResult,
)
from repro_torch.api.index import KNNIndex

# Register the built-in engines (import side effect populates the registry).
from repro_torch.api import engines as _engines  # noqa: F401

from repro_torch.core.brute import knn_brute
from repro_torch.core.chunked_jit import chunk_round_cache_size as knn_round_cache_size
from repro_torch.core.dualtree import dualtree_cache_size

__all__ = [
    "KNNIndex",
    "IndexSpec",
    "QueryResult",
    "RadiusResult",
    "StatResult",
    "SearchStats",
    "Plan",
    "plan",
    "estimate_slab_bytes",
    "estimate_meta_bytes",
    "BudgetError",
    "Engine",
    "EngineBase",
    "EngineCaps",
    "KNOWN_OPS",
    "MutabilityError",
    "OpUnsupported",
    "StreamingUnsupported",
    "register_engine",
    "get_engine",
    "available_engines",
    "knn_brute",
    "knn_round_cache_size",
    "dualtree_cache_size",
]
