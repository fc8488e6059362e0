"""Pointerless top tree for buffer k-d trees (paper §2.4, §3.1).

A numpy copy of ``repro.core.toptree``: the port imports nothing of the
JAX package, and the two builds must give identical trees from the same
points (the parity tests assert it), so the algorithm is kept line for
line.

The top tree is a classical k-d tree of height ``h`` with its split values
laid out pointer-less (implicit heap, 1-indexed): internal node ``v`` has
children ``2v`` / ``2v+1``; the ``2**h`` leaves are heap indices
``2**h .. 2**(h+1)-1``.  The *leaf structure* stores the reference points
re-arranged so every leaf owns a contiguous slab (``leaf_start`` /
``leaf_end``), the mapping back to the caller's indices, and a padded
``[n_leaves, leaf_pad, d]`` view whose pad rows hold ``PAD_COORD``.
Construction is host-side numpy with introselect medians.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

__all__ = [
    "TopTree",
    "build_top_tree",
    "default_buffer_size",
    "suggest_height",
    "tree_to_arrays",
    "tree_from_arrays",
]


@dataclasses.dataclass(frozen=True)
class TopTree:
    """Array-form buffer k-d tree (top tree + leaf structure)."""

    height: int                 # h >= 1; 2**h leaves
    n: int                      # number of reference points
    d: int                      # dimensionality
    split_dim: np.ndarray       # int32[2**h]      (index 0 unused; node v at [v] for v in 1..2**h-1)
    split_val: np.ndarray       # float32[2**h]
    leaf_start: np.ndarray      # int32[2**h]      slab starts into `points`
    leaf_end: np.ndarray        # int32[2**h]      slab ends (exclusive)
    points: np.ndarray          # float32[n, d]    re-arranged reference points
    orig_idx: np.ndarray        # int32[n]         points[i] == original[orig_idx[i]]
    points_padded: np.ndarray   # float32[2**h, leaf_pad, d]  (+inf padding)
    leaf_pad: int               # padded slab length (max leaf size rounded up)

    @property
    def n_leaves(self) -> int:
        return 1 << self.height

    @property
    def n_internal(self) -> int:
        return (1 << self.height) - 1

    @property
    def first_leaf_heap(self) -> int:
        """Heap index of leaf 0."""
        return 1 << self.height

    def leaf_sizes(self) -> np.ndarray:
        return self.leaf_end - self.leaf_start

    def device_arrays(self):
        """The arrays a device needs for traversal (tiny; replicated)."""
        return dict(
            split_dim=self.split_dim,
            split_val=self.split_val,
            leaf_start=self.leaf_start,
            leaf_end=self.leaf_end,
        )


def _round_up(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


# Padding coordinate for slab rows holding no real point.  Large but FINITE:
# the kernel's ||q||^2 - 2 q.x + ||x||^2 decomposition would produce NaN from
# inf * 0; 1e18 keeps ||x||^2 ~ 1e36 < f32 max while dominating any real
# distance (callers must keep |coords| << 1e15).  Mirrored by kernels/ref.py.
PAD_COORD = 1.0e18


def build_top_tree(
    points: np.ndarray,
    height: int,
    *,
    leaf_pad_multiple: int = 8,
    dim_rule: str = "cyclic",
    pad_value: float = PAD_COORD,
) -> TopTree:
    """Build a buffer k-d tree top tree + leaf structure.

    Args:
      points: float array [n, d] of reference points.
      height: tree height h; produces 2**h leaves.  Must satisfy
        ``2**h <= n`` so every leaf is non-empty.
      leaf_pad_multiple: pad the per-leaf slab view up to a multiple of this
        (sub-lane friendly; kernels later pad to their own tiles anyway).
      dim_rule: "cyclic" (level mod d, the paper's original rule) or
        "widest" (split the dimension of largest spread, footnote 2).
    """
    pts = np.ascontiguousarray(points, dtype=np.float32)
    if pts.ndim != 2:
        raise ValueError(f"points must be [n, d], got {pts.shape}")
    n, d = pts.shape
    if height < 1:
        raise ValueError("height must be >= 1")
    if (1 << height) > n:
        raise ValueError(f"2**height={1 << height} exceeds n={n}; every leaf must be non-empty")
    if dim_rule not in ("cyclic", "widest"):
        raise ValueError(f"unknown dim_rule {dim_rule!r}")

    n_internal = (1 << height) - 1
    n_leaves = 1 << height
    split_dim = np.zeros(n_internal + 1, dtype=np.int32)
    split_val = np.zeros(n_internal + 1, dtype=np.float32)
    leaf_start = np.zeros(n_leaves, dtype=np.int32)
    leaf_end = np.zeros(n_leaves, dtype=np.int32)

    # Iterative level-by-level construction over index ranges of `order`.
    order = np.arange(n, dtype=np.int64)
    # node_ranges[v] = (lo, hi) slice of `order` owned by heap node v.
    node_lo = np.zeros(2 * n_leaves, dtype=np.int64)
    node_hi = np.zeros(2 * n_leaves, dtype=np.int64)
    node_lo[1], node_hi[1] = 0, n

    for level in range(height):
        for v in range(1 << level, 1 << (level + 1)):
            lo, hi = node_lo[v], node_hi[v]
            seg = order[lo:hi]
            m = seg.shape[0]
            half = m // 2  # left gets floor(m/2)? paper: "(almost) equal-sized"
            # Use ceil for left so left >= right (matches classic kd builds).
            half = (m + 1) // 2
            if dim_rule == "cyclic":
                dim = level % d
            else:
                sub = pts[seg]
                dim = int(np.argmax(sub.max(axis=0) - sub.min(axis=0)))
            keys = pts[seg, dim]
            # introselect: element at position half-1 is the (lower) median;
            # everything left of `half` is <= everything right of it.
            part = np.argpartition(keys, half - 1 if half < m else m - 1)
            # ensure the boundary is a true median split: partition at half
            if half < m:
                part = np.argpartition(keys, [half - 1, half])
            seg_sorted = seg[part]
            med_lo = pts[seg_sorted[half - 1], dim]
            med_hi = pts[seg_sorted[half], dim] if half < m else med_lo
            sval = np.float32(med_lo)  # left covers keys <= sval
            order[lo:hi] = seg_sorted
            split_dim[v] = dim
            split_val[v] = sval
            node_lo[2 * v], node_hi[2 * v] = lo, lo + half
            node_lo[2 * v + 1], node_hi[2 * v + 1] = lo + half, hi

    first_leaf = 1 << height
    for leaf in range(n_leaves):
        v = first_leaf + leaf
        leaf_start[leaf] = node_lo[v]
        leaf_end[leaf] = node_hi[v]

    reordered = pts[order]
    orig_idx = order.astype(np.int32)

    max_leaf = int((leaf_end - leaf_start).max())
    leaf_pad = max(_round_up(max_leaf, leaf_pad_multiple), leaf_pad_multiple)
    padded = np.full((n_leaves, leaf_pad, d), np.float32(pad_value), dtype=np.float32)
    for leaf in range(n_leaves):
        s, e = leaf_start[leaf], leaf_end[leaf]
        padded[leaf, : e - s] = reordered[s:e]

    return TopTree(
        height=height,
        n=n,
        d=d,
        split_dim=split_dim,
        split_val=split_val,
        leaf_start=leaf_start,
        leaf_end=leaf_end,
        points=reordered,
        orig_idx=orig_idx,
        points_padded=padded,
        leaf_pad=leaf_pad,
    )


def tree_to_arrays(tree: TopTree, *, include_derived: bool = False) -> dict:
    """Flat array map of the tree (persistence format, and how a tree built
    by ``repro`` is carried into the port).

    With ``include_derived`` the leaf-ordered point slab and the padded
    slab ride along too.  They are derived data (recomputable from the
    split arrays + points), so storing them trades ~2x snapshot bytes
    for a restore that is pure I/O — no ``[n]`` gather, no padded-slab
    fill.  ``tree_from_arrays`` uses them when present and falls back to
    the rebuild otherwise, so both snapshot flavors stay readable.
    """
    out = {
        "split_dim": tree.split_dim,
        "split_val": tree.split_val,
        "leaf_start": tree.leaf_start,
        "leaf_end": tree.leaf_end,
        "orig_idx": tree.orig_idx,
    }
    if include_derived:
        out["points"] = tree.points
        out["points_padded"] = tree.points_padded
    return out


def tree_from_arrays(
    points_reordered: np.ndarray,
    arrays: dict,
    *,
    height: int,
    leaf_pad: int,
    pad_value: float = PAD_COORD,
) -> TopTree:
    """Rebuild a ``TopTree`` from persisted arrays WITHOUT re-running the
    O(h*n) median-split build — the core of the warm-restart speedup.

    ``points_reordered`` is the leaf-ordered point slab (``tree.points``
    at save time, or ``slab[orig_idx]`` when the caller persisted the
    original-order slab instead).  When the snapshot carries a
    ``points_padded`` slab (``tree_to_arrays(include_derived=True)``)
    the per-leaf fill is skipped entirely and the persisted slab is
    adopted as-is — with an mmap-backed array map this makes restore
    allocation-free for the bulk data.
    """
    pts = np.ascontiguousarray(points_reordered, np.float32)
    n, d = pts.shape
    leaf_start = np.asarray(arrays["leaf_start"], np.int32)
    leaf_end = np.asarray(arrays["leaf_end"], np.int32)
    n_leaves = 1 << height
    padded = arrays.get("points_padded")
    if padded is not None and (
        padded.shape != (n_leaves, leaf_pad, d) or padded.dtype != np.float32
    ):
        padded = None  # foreign/corrupt derived slab: rebuild from source
    if padded is None:
        padded = np.full((n_leaves, leaf_pad, d), np.float32(pad_value))
        for leaf in range(n_leaves):
            s, e = int(leaf_start[leaf]), int(leaf_end[leaf])
            padded[leaf, : e - s] = pts[s:e]
    return TopTree(
        height=height,
        n=n,
        d=d,
        split_dim=np.asarray(arrays["split_dim"], np.int32),
        split_val=np.asarray(arrays["split_val"], np.float32),
        leaf_start=leaf_start,
        leaf_end=leaf_end,
        points=pts,
        orig_idx=np.asarray(arrays["orig_idx"], np.int32),
        points_padded=padded,
        leaf_pad=leaf_pad,
    )


def default_buffer_size(height: int, cap: int = 4096) -> int:
    """Paper footnote 8: leaf-buffer capacity B = 2^(24-h), capped so
    CPU-scale runs stay sane (the paper notes exact values "did not have a
    significant influence").  The single source for both ``BufferKDTree``
    and the ``repro_torch.api`` planner."""
    return min(1 << max(1, 24 - height), cap)


def suggest_height(n: int, target_leaf: int = 4096, max_height: int = 20) -> int:
    """Paper guidance: 'big' leaves are what make device processing efficient
    (h=8..9 optimal at n=2e6 => leaves of ~4-8k points). Pick h so the mean
    leaf size is ~target_leaf."""
    h = max(1, int(np.floor(np.log2(max(2, n / max(1, target_leaf))))))
    return int(min(h, max_height))
