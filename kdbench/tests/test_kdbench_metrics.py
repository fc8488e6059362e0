"""The per-layer readers on a run record made by hand: what each reads,
and None where it finds nothing to read."""

import dataclasses

import pytest

from kdbench import catalog, harness
from kdbench.trace import Summary

CELL = catalog.load_cell("sdss_psf_d10.batch_jit")
SCAN = "void (anonymous namespace)::leaf_scan_narrow_kernel<10, 16, 0>(float const*)"


@dataclasses.dataclass
class Stats:
    iterations: int


def record(trace=None, rounds=(100, 300)):
    batches = [harness.Batch(0.0, 1.0, 10, Stats(r)) for r in rounds]
    return harness.Run(cell=CELL, build_s=12.5, batches=batches, trace=trace, window_s=10.0)


def summary(scan_s=0.5, scan_n=400, busy=2.0):
    return Summary(busy_s={0: busy}, kernels={SCAN: (scan_n, scan_s), "sort": (800, 1.0)},
                   device_ops=[], idle_gaps=[])


def read(name, run):
    return catalog.reader(CELL, name)(run)


def test_host_clock_and_counter_readers():
    assert read("build_s", record()) == 12.5
    assert read("rounds_per_batch", record()) == 200.0
    assert read("rounds_per_batch", record(rounds=(0,))) is None


def test_trace_readers():
    run = record(summary())
    assert read("launches_per_round", run) == pytest.approx(1200 / 400)
    assert read("leaf_scan_share_pct", run) == pytest.approx(25.0)
    assert read("device_idle_pct", run) == pytest.approx(80.0)
    for name in ("launches_per_round", "leaf_scan_share_pct", "device_idle_pct"):
        assert read(name, record()) is None


def test_busy_seconds_are_per_batch_and_not_of_the_window():
    # two batches, 2.0 busy seconds: the window's length (10.0) plays no part
    assert read("device_busy_s_per_batch", record(summary())) == pytest.approx(1.0)
    run = record(summary(), rounds=(100,))
    assert read("device_busy_s_per_batch", run) == pytest.approx(2.0)
    assert read("device_busy_s_per_batch", record()) is None
