"""How ``correct`` is decided: the answers of the timed batches against
the plain reference (``kdbench/reference``).

Three numbers, each against a limit that the configuration's ``check``
entry states:

- ``bad_rows``: rows of every answered batch with an id outside the
  catalogue, the same id twice, a distance that is not finite, or
  distances not ascending (limit 0).
- ``dist_err``: over every answered row, the largest gap between a
  reported distance and the float64 distance of the id reported beside
  it, as a share of the row's farthest such distance.
- ``rank_gap``: over a sample of rows drawn from the seed, the largest
  gap by which the j-th nearest of the reported ids lies farther than
  the reference's j-th nearest point, as a share of the reference's k-th
  distance.  An exact answer reads 0 up to float32 rounding; a missed
  neighbor reads the relative distance it lost.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

import numpy as np
import torch

from kdbench.reference import knn_fp64, sq_dists_of

NAMES = ("bad_rows", "dist_err", "rank_gap")
# rows of one piece of the all-rows pass (their gathered points in float64)
_ROWS = 2 ** 18


@dataclasses.dataclass
class Answer:
    """One answered batch: the queries handed to the program and what it
    returned for them."""

    queries: np.ndarray   # f32[m, d]
    dists: np.ndarray     # f32[m, k]
    ids: np.ndarray       # i64[m, k]


@dataclasses.dataclass
class Verdict:
    numbers: Dict[str, float]
    limits: Dict[str, float]
    rows: int            # rows judged by bad_rows and dist_err
    sampled: int         # rows judged by rank_gap

    @property
    def correct(self) -> bool:
        return all(self.numbers[k] <= self.limits[k] for k in NAMES)

    @property
    def failed(self) -> int:
        return int(self.numbers["bad_rows"])

    def report(self) -> Dict[str, Dict[str, float]]:
        return {k: {"value": self.numbers[k], "limit": self.limits[k]} for k in NAMES}


def bad_rows(n: int, dists: np.ndarray, ids: np.ndarray) -> np.ndarray:
    """bool[m]: rows that cannot be an answer whatever the distances are."""
    in_range = ((ids >= 0) & (ids < n)).all(1)
    s = np.sort(ids, axis=1)
    repeated = (s[:, 1:] == s[:, :-1]).any(1)
    finite = np.isfinite(dists).all(1)
    ascending = (dists[:, 1:] >= dists[:, :-1]).all(1)
    return ~in_range | repeated | ~finite | ~ascending


def _share(num: torch.Tensor, den: torch.Tensor) -> float:
    return float((num / den.clamp_min(torch.finfo(torch.float64).tiny)).max()) if num.numel() else 0.0


def sample_rows(seed: int, sizes: Sequence[int], count: int) -> List[np.ndarray]:
    """Per answered batch, the rows ``rank_gap`` judges: ``count`` drawn
    without replacement from all rows of all batches, from the seed."""
    total = int(sum(sizes))
    rng = np.random.default_rng([seed % 2 ** 63, 0x6B64])
    pick = np.sort(rng.choice(total, size=min(count, total), replace=False))
    out, lo = [], 0
    for m in sizes:
        out.append(pick[(pick >= lo) & (pick < lo + m)] - lo)
        lo += m
    return out


def judge(points: np.ndarray, answers: Sequence[Answer], sample: Sequence[np.ndarray],
          limits: Dict[str, float], device: torch.device) -> Verdict:
    """Judge ``answers`` (``sample[b]``: rows of batch b for ``rank_gap``)
    against the reference over ``points`` on ``device``."""
    n = points.shape[0]
    p = torch.from_numpy(points).to(device)
    bad, dist_err, rows = 0, 0.0, 0
    sq, si = [], []
    for a, rows_b in zip(answers, sample):
        a = Answer(a.queries, a.dists, np.asarray(a.ids, np.int64))
        bad_b = bad_rows(n, a.dists, a.ids)
        bad += int(bad_b.sum())
        rows += a.ids.shape[0]
        for lo in range(0, a.ids.shape[0], _ROWS):
            ok = ~bad_b[lo:lo + _ROWS]
            ids = torch.from_numpy(a.ids[lo:lo + _ROWS][ok]).to(device)
            q = torch.from_numpy(a.queries[lo:lo + _ROWS][ok]).to(device)
            d = torch.from_numpy(a.dists[lo:lo + _ROWS][ok]).to(device).double()
            true = sq_dists_of(p, q, ids).sqrt()
            dist_err = max(dist_err, _share((d - true).abs().amax(1), true.amax(1)))
        keep = rows_b[~bad_b[rows_b]]
        sq.append(a.queries[keep])
        si.append(a.ids[keep])
    q = torch.from_numpy(np.concatenate(sq)).to(device)
    ids = torch.from_numpy(np.concatenate(si)).to(device)
    k = ids.shape[1]
    rank_gap = 0.0
    if q.shape[0]:
        ref_d2, _ = knn_fp64(p, q, k)
        got = sq_dists_of(p, q, ids).sort(1).values.sqrt()
        ref = ref_d2.sqrt()
        rank_gap = _share((got - ref).amax(1), ref[:, -1])
    numbers = {"bad_rows": float(bad), "dist_err": dist_err, "rank_gap": rank_gap}
    return Verdict(numbers=numbers, limits={k: float(limits[k]) for k in NAMES}, rows=rows,
                   sampled=int(q.shape[0]))
