"""kdtree(i): CPU k-d tree baseline (paper baseline (2)).

The paper's competitor runs one classic depth-first k-d tree search per CPU
thread.  A per-query Python loop would benchmark the interpreter, not the
algorithm, so this baseline executes the *same* stackless traversal state
machine as the engine but level-synchronously over all queries in vectorized
numpy, with immediate (unbuffered, B=1-style) leaf processing — i.e. the
classic traversal semantics without the buffer k-d tree's work batching.
The contrast engine-vs-hostkdtree therefore isolates exactly what the paper
claims: the benefit of buffering + batched brute-force leaf scans.

Counterpart of ``repro.core.hostkdtree``, host numpy by its meaning (it
puts nothing on a device).  Distances are the direct (q - x)^2 form; a
neighbour at a non-finite distance (a NaN or overflowing query) is
reported as id -1, as every other engine of the port does (the reference
returns ids at +inf there).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from repro_torch.core.toptree import TopTree

__all__ = ["knn_host_kdtree"]


def knn_host_kdtree(
    queries: np.ndarray, tree: TopTree, k: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Exact kNN via classic (immediate-processing) traversal.

    Returns (Euclidean dists f32[m, k], idx i64[m, k] in original order).
    """
    q = np.asarray(queries, np.float32)
    m, d = q.shape
    h = tree.height
    first_leaf = 1 << h
    pts = tree.points

    node = np.ones((m,), np.int64)
    fromc = np.zeros((m,), np.int64)
    best_d = np.full((m, k), np.inf, np.float32)   # squared
    best_i = np.full((m, k), -1, np.int64)

    rows = np.arange(m)
    max_steps = (2 * h + 2) * (1 << (h + 1))  # generous safety bound
    for _ in range(max_steps):
        active = node != 0
        if not active.any():
            break
        at_leaf = active & (node >= first_leaf) & (fromc == 0)
        # --- immediate leaf processing, grouped by leaf --------------------
        if at_leaf.any():
            qi = rows[at_leaf]
            leaves = (node[at_leaf] - first_leaf).astype(np.int64)
            order = np.argsort(leaves, kind="stable")
            qi, leaves = qi[order], leaves[order]
            uniq, starts, counts = np.unique(
                leaves, return_index=True, return_counts=True
            )
            for u, s, c in zip(uniq, starts, counts):
                grp = qi[s : s + c]
                lo, hi = int(tree.leaf_start[u]), int(tree.leaf_end[u])
                diff = q[grp][:, None, :] - pts[None, lo:hi, :]
                dd = np.einsum("qld,qld->ql", diff, diff)
                cd = np.concatenate([best_d[grp], dd], axis=1)
                ci = np.concatenate(
                    [best_i[grp], np.broadcast_to(np.arange(lo, hi), dd.shape)],
                    axis=1,
                )
                sel = np.argpartition(cd, k - 1, axis=1)[:, :k]
                pd = np.take_along_axis(cd, sel, 1)
                pi = np.take_along_axis(ci, sel, 1)
                o2 = np.argsort(pd, axis=1, kind="stable")
                best_d[grp] = np.take_along_axis(pd, o2, 1)
                best_i[grp] = np.take_along_axis(pi, o2, 1)
            # exit the leaf
            fromc[at_leaf] = 1 + (node[at_leaf] & 1)
            node[at_leaf] = node[at_leaf] >> 1
            continue

        # --- one traversal transition for all moving queries ---------------
        mv = active
        v = node[mv]
        dim = tree.split_dim[v]
        val = tree.split_val[v]
        qv = q[mv, dim]
        go_left = qv <= val
        near = 2 * v + (~go_left)
        far = 2 * v + go_left
        descending = fromc[mv] == 0
        near_side = np.where(go_left, 1, 2)
        radius = np.sqrt(best_d[mv, k - 1])
        visit_far = (
            ~descending & (fromc[mv] == near_side) & (np.abs(qv - val) < radius)
        )
        at_root = v == 1
        parent = v >> 1
        side = 1 + (v & 1)
        new_node = np.where(
            descending, near, np.where(visit_far, far, np.where(at_root, 0, parent))
        )
        new_from = np.where(
            descending, 0, np.where(visit_far, 0, np.where(at_root, 0, side))
        )
        node[mv] = new_node
        fromc[mv] = new_from
    else:  # pragma: no cover
        raise RuntimeError("hostkdtree traversal exceeded safety bound")

    dists = np.sqrt(np.maximum(best_d, 0.0))
    idx = tree.orig_idx[np.clip(best_i, 0, None)].astype(np.int64)
    idx[(best_i < 0) | ~np.isfinite(best_d)] = -1
    return dists, idx
