"""Seeded point clouds for the kNN launcher.

Counterpart of the ``PointCloud`` of ``repro.data.pipeline``, copied so the
same seed gives the same points bit for bit (numpy's generators, the same
streams and the same order of draws): a mixture of Gaussians in d ~ 5..15,
the paper's astronomy catalogues' dimensionality.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

__all__ = ["PointCloud"]


class PointCloud:
    """Mixture-of-Gaussians reference/query points (paper-style data)."""

    def __init__(self, n: int, d: int, *, seed: int = 0, n_clusters: int = 32,
                 spread: float = 0.15):
        self.n, self.d, self.seed = int(n), int(d), seed
        self.n_clusters = n_clusters
        self.spread = spread

    def _centers(self) -> np.ndarray:
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, 2]))
        return rng.uniform(-1, 1, size=(self.n_clusters, self.d)).astype(np.float32)

    def points(self, *, offset: int = 0, count: Optional[int] = None) -> np.ndarray:
        count = self.n if count is None else count
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, 3, offset]))
        centers = self._centers()
        which = rng.integers(0, self.n_clusters, size=count)
        return (
            centers[which]
            + rng.normal(0, self.spread, size=(count, self.d)).astype(np.float32)
        ).astype(np.float32)

    def queries(self, m: int, *, seed_salt: int = 0) -> np.ndarray:
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, 4, seed_salt]))
        centers = self._centers()
        which = rng.integers(0, self.n_clusters, size=m)
        return (
            centers[which]
            + rng.normal(0, self.spread, size=(m, self.d)).astype(np.float32)
        ).astype(np.float32)
