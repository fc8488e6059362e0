"""Value types of the ``repro_torch.api`` front door.

Counterpart of ``repro.api.spec``: ``IndexSpec`` is what a caller asks for
(``None`` = let the planner decide), ``QueryResult`` what a query returns,
``RadiusResult`` and ``StatResult`` what the dual-tree ops return.  The
reference's ``compile_cache_dir`` (XLA's compile cache; nothing is
compiled here) is not here.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Iterator, Optional, Tuple

import numpy as np

from repro_torch.core.lazysearch import SearchStats

__all__ = ["IndexSpec", "QueryResult", "RadiusResult", "StatResult", "SearchStats"]


@dataclasses.dataclass(frozen=True)
class IndexSpec:
    """Declarative request for a kNN index; unset fields are planned."""

    engine: Optional[str] = None          # registry name; None => auto-plan
    op: str = "knn"                       # primary operation: "knn" |
                                          # "radius" | "kde" | "pair_count"
    height: Optional[int] = None          # top-tree height h (2**h leaves)
    n_chunks: Optional[int] = None        # out-of-core leaf-structure chunks
    n_shards: Optional[int] = None        # multi-device reference shards
    buffer_size: Optional[int] = None     # paper's B (leaf buffer slots)
    tile_q: int = 128                     # work-unit query tile width
    backend: str = "auto"                 # "auto" | "cuda" | "ref"
    k_hint: int = 10                      # expected k (plan-time cost model)
    m_hint: Optional[int] = None          # expected queries per batch
    devices: Optional[Tuple[Any, ...]] = None   # device slots; None => every
                                          # visible CUDA device
    memory_budget: Optional[int] = None   # device bytes for the leaf structure
    precision: Optional[str] = None       # "fp32" | "fp16" | "int8"
    strict_budget: bool = False           # over-budget plan raises BudgetError
    calibration: Optional[Any] = None     # planner.Calibration (measured costs);
                                          # None => plan by rule; the string
                                          # "refresh" measures the copy rate
                                          # inline when the port's calibration
                                          # files are missing or stale
    # -- mutation (the dynamic engine) ---------------------------------
    mutable: Optional[bool] = None        # True: the index takes insert /
                                          # delete (plans 'dynamic')
    merge_async: Optional[bool] = None    # dynamic engine: None => planner
                                          # decides (background carry merges)
    # -- crash-safe lifecycle (docs/OPERATIONS.md) ---------------------
    persist_dir: Optional[str] = None     # versioned snapshots + a mutation
                                          # WAL rooted here: build writes a
                                          # baseline snapshot, KNNIndex.load
                                          # resumes it
    snapshot_keep: int = 2                # complete versions save() keeps
    wal_fsync: bool = True                # fsync each WAL record before the
                                          # mutation is acknowledged

    def replace(self, **kw) -> "IndexSpec":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class QueryResult:
    """One query batch's answer: ascending Euclidean ``dists`` f32[m, k],
    ``idx`` i64[m, k] into the caller's original ordering (-1 = none)."""

    dists: np.ndarray
    idx: np.ndarray
    stats: SearchStats
    engine: str
    k: int

    def __iter__(self) -> Iterator[np.ndarray]:
        return iter((self.dists, self.idx))

    def __len__(self) -> int:
        return 2

    def __getitem__(self, i):
        return (self.dists, self.idx)[i]


@dataclasses.dataclass(frozen=True)
class RadiusResult:
    """One radius-search batch's answer, CSR over query rows: row ``i``'s
    neighbors are ``indices[indptr[i]:indptr[i+1]]`` (i64, into the
    caller's original ``points`` ordering) with ascending Euclidean
    ``dists`` (f32); inclusive of ``dist == r``.  Unpacks like the classic
    ``(indptr, indices, dists)`` triple."""

    indptr: np.ndarray
    indices: np.ndarray
    dists: np.ndarray
    stats: SearchStats
    engine: str
    r: float

    def __iter__(self) -> Iterator[np.ndarray]:
        return iter((self.indptr, self.indices, self.dists))

    def __len__(self) -> int:
        return 3

    def __getitem__(self, i):
        return (self.indptr, self.indices, self.dists)[i]


@dataclasses.dataclass(frozen=True)
class StatResult:
    """A statistical op's answer: ``values`` is the per-query density
    vector (kde, f32[m]) or the pair-distance histogram (pair_count,
    i64[n_bins]); ``error_bound`` is the op's accumulated absolute error
    bound (0.0 = exact).  Unpacks as ``(values, error_bound)``."""

    values: np.ndarray
    error_bound: float
    stats: SearchStats
    engine: str
    op: str

    def __iter__(self) -> Iterator:
        return iter((self.values, self.error_bound))

    def __len__(self) -> int:
        return 2

    def __getitem__(self, i):
        return (self.values, self.error_bound)[i]
