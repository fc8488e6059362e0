"""Plain-torch oracles for the kNN leaf-scan kernel.

Counterpart of ``repro.kernels.ref``:

* ``leaf_scan_ref`` — the work-unit contract of the leaf-scan kernel
  (``kernels/knn_scan.py``): per work unit, the k smallest squared
  distances of a padded query tile against a padded leaf slab, with
  *local* slab indices, via the same ||q||^2 - 2 q.x + ||x||^2
  decomposition (clamped at 0, fp32).
* ``knn_brute_ref`` — exact brute-force kNN by direct squared differences.

``lax.top_k`` breaks ties toward the lowest index; ``torch.topk`` promises
no order.  Every selection here (and in the rest of the port) is a stable
sort followed by a slice, which keeps the lowest index first.
"""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = [
    "leaf_scan_ref",
    "knn_brute_ref",
    "smallest_k",
    "PAD_COORD",
    "INVALID_DIST",
]

# Padding coordinate for slab rows that hold no real point.  Large but
# finite so the decomposition stays NaN-free; any distance >= INVALID_DIST
# is "no candidate" to callers.
PAD_COORD = 1.0e18
INVALID_DIST = 1.0e30


def smallest_k(d: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k smallest values along the last axis, ascending, ties to the
    lowest index (``lax.top_k(-d, k)`` order)."""
    vals, idx = torch.sort(d, dim=-1, stable=True)
    return vals[..., :k], idx[..., :k]


def _decomposed_sq_dists(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """[..., TQ, d] x [..., L, d] -> [..., TQ, L] squared distances."""
    qn = torch.sum(q * q, dim=-1, keepdim=True)
    xn = torch.sum(x * x, dim=-1).unsqueeze(-2)
    cross = torch.matmul(q, x.transpose(-1, -2))
    return torch.clamp(qn - 2.0 * cross + xn, min=0.0)


def leaf_scan_ref(
    q: torch.Tensor, leaf_pts: torch.Tensor, *, k: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Oracle for the leaf-scan work-unit kernel.

    q f32[W, TQ, d_pad], leaf_pts f32[W, L_pad, d_pad] ->
    (f32[W, TQ, k] ascending squared distances, i32[W, TQ, k] local
    indices).
    """
    d, i = smallest_k(_decomposed_sq_dists(q, leaf_pts), k)
    return d, i.to(torch.int32)


def knn_brute_ref(
    queries: torch.Tensor, points: torch.Tensor, *, k: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact brute-force kNN, direct (q - x)^2.  Returns (f32[m, k] squared
    distances, i32[m, k] indices), ascending."""
    d2 = torch.sum((queries[:, None, :] - points[None, :, :]) ** 2, dim=-1)
    d, i = smallest_k(d2, k)
    return d, i.to(torch.int32)
