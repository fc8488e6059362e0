"""Value types of the ``repro_torch.api`` front door.

Counterpart of ``repro.api.spec``: ``IndexSpec`` is what a caller asks for
(``None`` = let the planner decide), ``QueryResult`` what a query returns.
The fields of the reference's spec that belong to engines not ported yet
(calibration, compile cache, mutation, persistence) are not here.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Iterator, Optional, Tuple

import numpy as np

from repro_torch.core.lazysearch import SearchStats

__all__ = ["IndexSpec", "QueryResult", "SearchStats"]


@dataclasses.dataclass(frozen=True)
class IndexSpec:
    """Declarative request for a kNN index; unset fields are planned."""

    engine: Optional[str] = None          # registry name; None => auto-plan
    op: str = "knn"                       # primary operation ("knn" only
                                          # is declared by the ported engines)
    height: Optional[int] = None          # top-tree height h (2**h leaves)
    n_chunks: Optional[int] = None        # out-of-core leaf-structure chunks
    n_shards: Optional[int] = None        # multi-device reference shards
    buffer_size: Optional[int] = None     # paper's B (leaf buffer slots)
    tile_q: int = 128                     # work-unit query tile width
    backend: str = "auto"                 # "auto" | "cuda" | "ref"
    k_hint: int = 10                      # expected k (plan-time cost model)
    m_hint: Optional[int] = None          # expected queries per batch
    devices: Optional[Tuple[Any, ...]] = None   # None => (cuda:0,)
    memory_budget: Optional[int] = None   # device bytes for the leaf structure
    precision: Optional[str] = None       # "fp32" | "fp16" | "int8"
    strict_budget: bool = False           # over-budget plan raises BudgetError

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
