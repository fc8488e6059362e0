"""Tiled brute-force kNN: the exact ground truth (paper baseline (3)).

Counterpart of ``repro.core.brute``.  Query tiles stay resident while
reference tiles stream through ``_tile_step`` (direct (q - x)^2 distances,
then a stable-sort merge into the running top-k).  Runs on whatever device
it is given; the last reference tile is simply shorter (no jit shapes to
keep fixed, so no padding rows).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.kernels.ref import smallest_k

__all__ = ["knn_brute"]


def _tile_step(
    q: torch.Tensor,        # f32[TQ, d]
    x: torch.Tensor,        # f32[TX, d]
    base: int,              # global offset of this reference tile
    best_d: torch.Tensor,   # f32[TQ, k]
    best_i: torch.Tensor,   # i64[TQ, k]
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    # direct (q - x)^2: this is the oracle, so exactness beats the
    # decomposed form.  An elementwise product and a sum over d (the
    # reference's fused einsum): torch.einsum would lower this to a batched
    # matrix-vector product of one-row matrices, which runs far slower on
    # the card
    diff = q[:, None, :] - x[None, :, :]
    dist = torch.sum(diff * diff, dim=-1)
    idx = torch.arange(base, base + x.shape[0], device=q.device).expand_as(dist)
    cd = torch.cat([best_d, dist], dim=1)
    ci = torch.cat([best_i, idx], dim=1)
    sd, sel = smallest_k(cd, k)
    return sd, torch.gather(ci, 1, sel)


def knn_brute(
    queries,
    points,
    k: int,
    *,
    device=None,
    tile_q: int = 1024,
    tile_x: int = 16384,
) -> Tuple[np.ndarray, np.ndarray]:
    """Exact kNN; returns (Euclidean dists f32[m, k], idx i64[m, k]).

    ``queries``/``points`` are numpy arrays or tensors; ``device`` defaults
    to the device of ``points`` when it is a tensor, else to ``cuda:0``.
    """
    from repro_torch.kernels.ops import owned_tensor, resolve_device, sqrt

    if device is None and isinstance(points, torch.Tensor):
        device = points.device
    dev = resolve_device(device)
    qs = owned_tensor(queries, dev)
    if isinstance(points, torch.Tensor):
        pts = owned_tensor(points, dev)
    elif dev.type == "cpu":
        pts = np.array(points, np.float32, copy=True)
    else:
        # host points go to the device one reference tile at a time (each
        # tile a copy on the device)
        pts = np.asarray(points, dtype=np.float32)
    m, d = qs.shape
    n, d2 = pts.shape
    if d != d2:
        raise ValueError(f"dim mismatch {d} vs {d2}")
    if k > n:
        raise ValueError(f"k={k} > n={n}")

    out_d = np.empty((m, k), np.float32)
    out_i = np.empty((m, k), np.int64)
    for qs0 in range(0, m, tile_q):
        q = qs[qs0 : qs0 + tile_q]
        best_d = torch.full((q.shape[0], k), float("inf"), device=dev)
        best_i = torch.full((q.shape[0], k), -1, dtype=torch.int64, device=dev)
        for xs in range(0, n, tile_x):
            x = torch.as_tensor(pts[xs : xs + tile_x], device=dev)
            best_d, best_i = _tile_step(q, x, xs, best_d, best_i, k)
        out_d[qs0 : qs0 + q.shape[0]] = sqrt(best_d).cpu().numpy()
        out_i[qs0 : qs0 + q.shape[0]] = best_i.cpu().numpy()
    return out_d, out_i
