"""Seeded data: token batches for the LM stack, point clouds for the kNN
launcher.

Counterparts of ``repro.data.pipeline``'s ``TokenPipeline`` and
``PointCloud``, copied (numpy only) so the same seed gives the same batches
and points bit for bit: the same streams, the same order of draws.

``TokenPipeline``: every batch is a pure function of (seed, step, shard),
a walk over a fixed random token-transition table (each token has
``branching`` likely successors, 10 % jumps), so the next token is
learnable.  ``PointCloud``: a mixture of Gaussians in d ~ 5..15, the
paper's astronomy catalogues' dimensionality.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

__all__ = ["TokenPipeline", "PointCloud"]


class TokenPipeline:
    """Markov-chain token batches, shard-addressable and stateless."""

    def __init__(self, vocab_size: int, seq_len: int, global_batch: int, *,
                 seed: int = 0, n_shards: int = 1, branching: int = 4):
        self.vocab = int(vocab_size)
        self.seq = int(seq_len)
        self.global_batch = int(global_batch)
        self.n_shards = int(n_shards)
        if global_batch % n_shards:
            raise ValueError(f"global_batch {global_batch} % n_shards {n_shards} != 0")
        self.seed = seed
        rng = np.random.default_rng(np.random.SeedSequence([seed, 7]))
        self.table = rng.integers(0, self.vocab, size=(self.vocab, branching), dtype=np.int32)

    def _rng(self, step: int, shard: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.seed, 1, int(step), int(shard)]))

    def shard_batch(self, step: int, shard: int) -> Dict[str, np.ndarray]:
        """Batch for one shard: tokens / labels i32[B_local, S]."""
        b_local = self.global_batch // self.n_shards
        rng = self._rng(step, shard)
        toks = np.empty((b_local, self.seq + 1), np.int32)
        toks[:, 0] = rng.integers(0, self.vocab, size=b_local)
        choices = rng.integers(0, self.table.shape[1], size=(b_local, self.seq))
        noise = rng.random((b_local, self.seq)) < 0.1
        jumps = rng.integers(0, self.vocab, size=(b_local, self.seq), dtype=np.int32)
        for t in range(self.seq):
            nxt = self.table[toks[:, t], choices[:, t]]
            toks[:, t + 1] = np.where(noise[:, t], jumps[:, t], nxt)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}

    def global_batch_at(self, step: int) -> Dict[str, np.ndarray]:
        parts = [self.shard_batch(step, s) for s in range(self.n_shards)]
        return {k: np.concatenate([p[k] for p in parts], axis=0) for k in parts[0]}

    @staticmethod
    def state_for(step: int) -> dict:
        """The checkpointable state: the step counter (kept by the caller)."""
        return {"data_step": int(step)}


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
