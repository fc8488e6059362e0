"""The plain reference: brute-force kNN in plain PyTorch.

It takes the points and queries the program was handed and works out
everything else itself.  It imports nothing of ``repro_torch`` (nor
``jax`` or ``repro``): ``kdbench/tests`` holds it to that.

``knn_fp64`` is the reference: every squared distance in float64, the k
smallest per query.  ``knn_tf32`` is the control: the same brute force
in the precision below the catalogue's float32, its distance products
taken in TF32 (the operands rounded to TF32's 10-bit mantissa, the
products summed in float32, as a card's matrix unit does with TF32
allowed; rounded here so that the control is TF32 whichever kernel the
library picks), which a correct comparison has to refuse.  ``sq_dists_of`` gives the float64 squared
distance of given ids, which judges the distances a program reports.
"""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["knn_fp64", "knn_tf32", "sq_dists_of"]

# elements of one block of the [queries, points] distance matrix
_BLOCK_ELEMS = 2 ** 29


def _blocked_topk(q: torch.Tensor, p: torch.Tensor, k: int, cross) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k smallest of |q|^2 + |p|^2 - 2 cross(q, p) per row of q, over
    blocks of p; (squared distances ascending, ids i64)."""
    q2 = (q * q).sum(1, keepdim=True)
    p2 = (p * p).sum(1)
    block = max(k, _BLOCK_ELEMS // max(1, q.shape[0]))
    best_d = best_i = None
    for lo in range(0, p.shape[0], block):
        blk = p[lo:lo + block]
        d2 = (q2 + p2[lo:lo + block][None, :] - 2.0 * cross(q, blk)).clamp_min_(0.0)
        kk = min(k, blk.shape[0])
        bd, bi = torch.topk(d2, kk, dim=1, largest=False, sorted=False)
        bi = bi + lo
        if best_d is None:
            best_d, best_i = bd, bi
        else:
            best_d, sel = torch.topk(torch.cat([best_d, bd], 1), min(k, best_d.shape[1] + kk),
                                     dim=1, largest=False, sorted=False)
            best_i = torch.gather(torch.cat([best_i, bi], 1), 1, sel)
    order = torch.argsort(best_d, dim=1, stable=True)
    return torch.gather(best_d, 1, order), torch.gather(best_i, 1, order)


def knn_fp64(points: torch.Tensor, queries: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(squared distances f64[m, k] ascending, ids i64[m, k]) of the k
    nearest points of each query, in float64 throughout."""
    p, q = points.double(), queries.double()
    return _blocked_topk(q, p, k, lambda a, b: a @ b.T)


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (10 explicit mantissa bits, to nearest)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def knn_tf32(points: torch.Tensor, queries: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The control: (Euclidean distances f32[m, k] ascending, ids i64[m, k])
    of the brute force with its products in TF32."""
    p, q = points.float(), queries.float()
    d2, ids = _blocked_topk(q, p, k, lambda a, b: _tf32(a) @ _tf32(b).T)
    return d2.sqrt(), ids


def sq_dists_of(points: torch.Tensor, queries: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """f64[m, k]: the squared distance of ``queries[r]`` to ``points[ids[r,
    j]]``, each a float64 sum of squared differences (ids must index
    ``points``)."""
    diff = points[ids].double() - queries.double()[:, None, :]
    return (diff * diff).sum(-1)
