"""The traced window: ``torch.profiler`` over CUDA activity, kept in memory
and reduced here (no chrome trace is written).

Only CUDA activity is traced: the device's kernels, copies and fills and
the host's CUDA runtime calls.  Recording every torch op on the host as
well doubled a ``.batch`` window (30 s to 64 s) and gave 10.5 M events,
which took 190 s to gather and reduce.  The reduction reads the raw events
once: device intervals per card, their union (a card is busy while any of
its streams runs something), kernel time and count by name, and the
runtime call in flight in the middle of each of the longest idle gaps
("(no runtime call)": the host was in Python or numpy).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np

TOP = 10


@dataclasses.dataclass
class Summary:
    """What the per-layer readers and the ``breakdown`` take from a trace."""

    busy_s: Dict[int, float]                  # card -> union of its device intervals
    kernels: Dict[str, Tuple[int, float]]     # kernel name -> (launches, device s)
    device_ops: List[Tuple[str, float]]       # the TOP device ops by device s
    idle_gaps: List[Tuple[str, float]]        # the TOP idle gaps, by runtime call

    @property
    def kernel_launches(self) -> int:
        return sum(c for c, _ in self.kernels.values())


def union(starts: np.ndarray, ends: np.ndarray) -> Tuple[float, np.ndarray, np.ndarray]:
    """The union of intervals [starts[i], ends[i]): (its length, and the
    gaps between its pieces as (gap starts, gap ends))."""
    if starts.size == 0:
        return 0.0, np.empty(0), np.empty(0)
    order = np.argsort(starts, kind="stable")
    s, e = starts[order], ends[order]
    reach = np.maximum.accumulate(e)
    new = np.empty(s.size, bool)
    new[0] = True
    new[1:] = s[1:] > reach[:-1]
    first = np.flatnonzero(new)
    piece_s = s[first]
    piece_e = reach[np.r_[first[1:] - 1, s.size - 1]]
    return float((piece_e - piece_s).sum()), piece_e[:-1], piece_s[1:]


def _is_kernel(name: str) -> bool:
    return not (name.startswith("Memcpy") or name.startswith("Memset"))


def summarize(events) -> Summary:
    """Reduce the profiler's raw events (``prof.profiler.kineto_results
    .events()``)."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    dev: Dict[int, List[int]] = {}          # card -> [start, end, start, end, ...]
    by_name: Dict[str, List[float]] = {}
    host, host_at = [], []                  # [start, end, ...], event index
    for i, ev in enumerate(events):
        start = ev.start_ns()
        end = start + ev.duration_ns()
        if ev.device_type() == cuda:
            dev.setdefault(ev.device_index(), []).extend((start, end))
            acc = by_name.get(ev.name())
            if acc is None:
                by_name[ev.name()] = [1, end - start]
            else:
                acc[0] += 1
                acc[1] += end - start
        else:
            host.extend((start, end))
            host_at.append(i)
    by_name = {n: (c, ns / 1e9) for n, (c, ns) in by_name.items()}
    busy, gaps = {}, []
    for card, se in dev.items():
        se = np.asarray(se, np.int64)
        length, g0, g1 = union(se[0::2], se[1::2])
        busy[card] = length / 1e9
        length = g1 - g0
        gaps += [(int(length[j]), int(g0[j]), int(g1[j])) for j in np.argsort(length)[::-1][:TOP]]
    gaps.sort(key=lambda g: g[0], reverse=True)
    host = np.asarray(host, np.int64)
    hs, he = host[0::2], host[1::2]
    idle = []
    for length, g0, g1 in gaps[:TOP]:
        mid = (g0 + g1) // 2
        over = np.flatnonzero((hs <= mid) & (he >= mid))
        label = "(no runtime call)"
        if over.size:   # the innermost call running at the gap's middle
            label = events[host_at[over[np.argmin(he[over] - hs[over])]]].name()
        idle.append((label, float(length) / 1e9))
    ops = sorted(((n, s) for n, (_, s) in by_name.items()), key=lambda x: x[1], reverse=True)
    kernels = {n: (int(c), s) for n, (c, s) in by_name.items() if _is_kernel(n)}
    return Summary(busy_s=busy, kernels=kernels, device_ops=ops[:TOP], idle_gaps=idle)


class Profiler:
    """``with Profiler() as p: ...`` then ``p.summary``."""

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        # without a card (the CPU tests) the host's torch ops stand in
        on_card = torch.cuda.is_available()
        self._prof = profile(activities=[ProfilerActivity.CUDA if on_card else ProfilerActivity.CPU])
        self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        import time

        t0 = time.perf_counter()
        self._prof.__exit__(*exc)
        t1 = time.perf_counter()
        if exc[0] is None:
            events = self._prof.profiler.kineto_results.events()
            self.events = len(events)
            self.summary = summarize(events)
        self.stop_s, self.reduce_s = t1 - t0, time.perf_counter() - t1
        self._prof = None
        return False
