"""The catalogue of ``chip_smoke.py::main_data`` (frozen copy): a seeded
64-component Gaussian mixture, its points first, then the query batch as
held-out draws of the same mixture, from one ``numpy`` generator.

The arrays come from the configuration's ``data_seed`` (``draw``), and the
run's seed puts the points and the batch's queries in an order of its own
(``make``): every seed hands the program other ids and another query
order over the same catalogue, so every seed asks for the same work.  A
seed that drew the data anew would change it: the round loop runs until
the batch's hardest query is done, and how hard that query is varies from
draw to draw (1612 to 1984 rounds a batch over three draws of 2**20
queries from one mixture).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def mixture(rng, n: int, d: int, centers: np.ndarray, scales: np.ndarray) -> np.ndarray:
    """n points from a clustered Gaussian mixture (seeded)."""
    lab = rng.integers(0, centers.shape[0], size=n)
    pts = rng.standard_normal(size=(n, d), dtype=np.float32)
    pts *= scales[lab, None]
    pts += centers[lab]
    return pts


def draw(seed: int, n: int, d: int, batch: int, *, components: int,
         center_scale: float, scale_low: float, scale_high: float
         ) -> Tuple[np.ndarray, np.ndarray]:
    """(points f32[n, d], queries f32[batch, d]): ``main_data(seed)``'s
    points and, for ``batch`` its m, its queries (a larger batch continues
    its draws)."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(scale=center_scale, size=(components, d)).astype(np.float32)
    scales = rng.uniform(scale_low, scale_high, size=components).astype(np.float32)
    points = mixture(rng, n, d, centers, scales)
    return points, mixture(rng, batch, d, centers, scales)


def make(seed: int, n: int, d: int, batch: int, *, data_seed: int,
         **shape) -> Tuple[np.ndarray, np.ndarray]:
    """``draw(data_seed, ...)``'s arrays, their rows in the order of ``seed``."""
    points, queries = draw(data_seed, n, d, batch, **shape)
    rng = np.random.default_rng(seed)
    return points[rng.permutation(n)], queries[rng.permutation(batch)]
