"""The readers of the jit engine's counts, phase stamps and host spans: on
a run record made by hand, what each reads and None where it finds
nothing; and a traced jit run on the CPU that reports them."""

import dataclasses
import sys

import pytest

from kdbench import harness
from kdbench.tests.helpers import tiny_root
from kdbench.tests.test_kdbench_metrics import CELL, read, record, summary
from kdbench.tests.test_kdbench_runs import run

PHASES = (("advance", 1.0), ("plan", 2.0), ("scan", 0.5), ("merge", 3.0))


@dataclasses.dataclass
class JitStats:
    iterations: int
    steady_rounds: int
    leaf_visits: int
    useful_pairs: int
    scan_pairs: int
    phase_s: tuple
    call: int


def jit_record(trace=None):
    """Two batches of 100 queries, as the jit engine reports them."""
    stats = [JitStats(100, 104, 2000, 50_000, 200_000, PHASES, call=7),
             JitStats(300, 304, 4000, 70_000, 400_000,
                      tuple((n, 2 * s) for n, s in PHASES), call=9)]
    batches = [harness.Batch(0.0, 1.0, 100, st) for st in stats]
    return harness.Run(cell=CELL, build_s=12.5, batches=batches, trace=trace, window_s=10.0)


def spans():
    """Two builds (the last one's call is 5), two warms, and the window's
    calls 7 and 9 beside an older call 3."""
    from repro_torch.tracing import Span

    def s(name, sec, sid, parent, call):
        return Span(name, 10 ** 9, 10 ** 9 + int(sec * 1e9), sid, parent, call)

    return [s("build.tree", 9.0, 2, 1, 1), s("build", 10.0, 1, 0, 1),
            s("build.tree", 1.5, 6, 5, 5), s("build.tree", 0.5, 7, 5, 5),
            s("build.upload", 0.25, 8, 5, 5), s("build", 2.5, 5, 0, 5),
            s("build.tree", 4.0, 20, 0, 20), s("warm", 3.0, 4, 0, 4), s("warm", 1.25, 10, 0, 10),
            s("query.rescore", 8.0, 31, 30, 3), s("query.rounds", 5.0, 41, 7, 7),
            s("query.rescore", 0.1, 42, 7, 7), s("query.certify", 0.3, 43, 7, 7),
            s("query.readback", 0.2, 51, 9, 9), s("query.brute", 0.4, 52, 9, 9)]


def _no_counts(mp):
    """Stats without the counts (another engine, or the program before them)."""
    return record(summary())


def _no_trace(mp):
    return jit_record(None)


def _no_spans(mp):
    from repro_torch import tracing

    mp.setattr(tracing, "spans", list)
    return jit_record(summary())


def _no_tracing_module(mp):
    import repro_torch

    mp.delattr(repro_torch, "tracing")
    mp.setitem(sys.modules, "repro_torch.tracing", None)
    return jit_record(summary())


SCAN_OPS = 600_000 * (2 * 10 + 3)
SPANS = (_no_spans, _no_tracing_module)
JIT_READERS = [
    ("round_fill_pct", 100.0 * 6000 / (100 * 104 + 100 * 304), (_no_counts,)),
    ("scan_fill_pct", 100.0 * 120_000 / 600_000, (_no_counts,)),
    ("leaf_scan_roofline", 100.0 * SCAN_OPS / (67e12 * 0.5), (_no_counts, _no_trace)),
    ("advance_s_per_batch", 1.5, (_no_counts,)),
    ("plan_s_per_batch", 3.0, (_no_counts,)),
    ("merge_s_per_batch", 4.5, (_no_counts,)),
    ("finalize_s_per_batch", (0.1 + 0.3 + 0.2 + 0.4) / 2, (_no_counts,) + SPANS),
    ("host_tree_build_s", 2.0, SPANS),
    ("warm_s", 1.25, SPANS),
]


@pytest.mark.parametrize("name,want,nothing", JIT_READERS, ids=[r[0] for r in JIT_READERS])
def test_jit_readers(name, want, nothing, monkeypatch):
    from repro_torch import tracing

    monkeypatch.setattr(tracing, "spans", spans)
    assert read(name, jit_record(summary())) == pytest.approx(want)
    for make in nothing:
        with monkeypatch.context() as mp:
            assert read(name, make(mp)) is None, make.__name__


def test_the_traced_jit_run_reports_its_counts_stamps_and_spans(tmp_path):
    res, _ = run(tiny_root(tmp_path, n=2 ** 13, spec={"engine": "jit"}), trace=1)
    assert res["correct"] is True
    got = {name: m["value"] for name, m in res["metrics"].items()}
    for name in ("round_fill_pct", "scan_fill_pct"):
        assert 0 < got[name] <= 100, name
    for name in ("advance_s_per_batch", "plan_s_per_batch", "merge_s_per_batch",
                 "finalize_s_per_batch", "host_tree_build_s", "warm_s"):
        assert got[name] > 0, name
    # the CPU runs no leaf-scan kernel: its roofline has nothing to read
    assert "leaf_scan_roofline" not in got
