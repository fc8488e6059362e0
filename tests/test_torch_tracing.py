"""The jit engine's device counts, phase stamps and host spans, on the CPU.

The round counts its own work (a log on the device, read back into
``JitRounds.last`` and the query's ``SearchStats``) and stamps its phases;
the facade and the engine record host spans (``repro_torch.tracing``).  The
counts are held against the same sums recomputed round by round from
``_build_plan``'s inputs and outputs, the stamps against the host span
around the rounds, the spans against each other.  On the CPU the round runs
eagerly and the stamps read the host's clock; the captured round's counts
and stamps are held on the card in ``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

from repro_torch import tracing
from repro_torch.api import IndexSpec, KNNIndex
from repro_torch.core import jitsearch
from repro_torch.core.lazysearch import FP32_OVERFETCH
from repro_torch.core.toptree import build_top_tree
from repro_torch.kernels.stamp import trace_bounds

CPU = torch.device("cpu")
M, K = 300, 5


def _data(n=3000, m=M, d=4, seed=3):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, d)).astype(np.float32),
            rng.normal(size=(m, d)).astype(np.float32))


@pytest.fixture(scope="module")
def jit_index():
    pts, q = _data()
    index = KNNIndex.build(pts, IndexSpec(engine="jit", height=4, devices=(CPU,)))
    index.warm(M, K)
    return index, q


def _recount(monkeypatch, index, q):
    """Query through the index with ``_build_plan`` spied on: each round's
    (visits, real pairs, units) recomputed from its leaves and its plan."""
    sizes = index._state.tree.leaf_size.long()
    rows = []
    real = jitsearch._build_plan

    def spy(leaf, tq, n_leaves):
        plan = real(leaf, tq, n_leaves)
        placed = leaf[leaf >= 0].long()
        rows.append((placed.numel(), int(sizes[placed].sum()), int(plan[2])))
        return plan

    monkeypatch.setattr(jitsearch, "_build_plan", spy)
    res = index.query(q, K)
    return res, np.array(rows, np.int64).reshape(-1, 3)


def test_device_counts_equal_the_plans_round_by_round(jit_index, monkeypatch):
    index, q = jit_index
    res, rows = _recount(monkeypatch, index, q)
    st = res.stats
    r = index._state.rounds[(M, K + FP32_OVERFETCH)]
    visits, pairs, units = rows.sum(0)
    assert (st.leaf_visits, st.useful_pairs, st.units_scanned) == (visits, pairs, units) > (0,) * 3
    assert st.scan_pairs == units * r.tq * r.tree.slabs.shape[1] > st.useful_pairs
    # every round is live here (the CPU syncs each round), so the log holds
    # them all, in order, and sums to the totals
    assert st.steady_rounds == st.iterations == len(rows) == len(r.last.log)
    np.testing.assert_array_equal(r.last.log, rows)
    assert tuple(r.last.log.sum(0)) == (visits, pairs, units)
    assert st.leaf_visits <= M * st.steady_rounds


def test_rounds_past_the_logs_end_count_in_the_sums(monkeypatch):
    pts, q = _data(seed=4)
    tree = build_top_tree(pts, 4)
    ta = jitsearch.tree_arrays_from(tree, CPU)
    kw = dict(tq=16, first_leaf_heap=tree.first_leaf_heap)
    full = jitsearch.JitRounds(ta, M, K, **kw)
    full.run(torch.from_numpy(q))
    monkeypatch.setattr(jitsearch, "LOG_ROUNDS", 3)
    short = jitsearch.JitRounds(ta, M, K, **kw)
    short.run(torch.from_numpy(q))
    a, b = full.last, short.last
    assert len(a.log) > 3 and len(b.log) == 3
    np.testing.assert_array_equal(b.log, a.log[:3])
    for f in ("leaf_visits", "useful_pairs", "units_scanned", "executed"):
        assert getattr(b, f) == getattr(a, f), f


def test_two_calls_report_the_same_counts(jit_index):
    index, q = jit_index
    a, b = index.query(q, K).stats, index.query(q, K).stats
    fields = ("iterations", "steady_rounds", "units_scanned", "leaf_visits", "useful_pairs",
              "scan_pairs")
    assert [getattr(a, f) for f in fields] == [getattr(b, f) for f in fields]
    assert a.call != b.call


def test_phase_seconds_lie_inside_the_rounds_span(jit_index):
    index, q = jit_index
    tracing.clear()
    st = index.query(q, K).stats
    assert [name for name, _ in st.phase_s] == list(jitsearch.PHASES)
    assert all(s > 0 for _, s in st.phase_s)
    (rounds,) = [s for s in tracing.spans() if s.name == "query.rounds" and s.call == st.call]
    assert sum(s for _, s in st.phase_s) <= rounds.seconds


def _check_nesting(spans, call):
    """Every span of ``call`` nests in its parent and the call's one
    ``query`` span holds them all; returns the names by parent name."""
    mine = {s.id: s for s in spans if s.call == call}
    (top,) = [s for s in mine.values() if s.name == "query"]
    assert top.parent == 0 and top.id == call
    under = {}
    for s in mine.values():
        if s is top:
            continue
        parent = mine[s.parent]
        assert parent.start_ns <= s.start_ns <= s.end_ns <= parent.end_ns
        assert top.start_ns <= s.start_ns and s.end_ns <= top.end_ns
        under.setdefault(parent.name, []).append(s.name)
    return under


def test_spans_nest_and_carry_the_call(jit_index):
    index, q = jit_index
    tracing.clear()
    st = index.query(q, K).stats
    under = _check_nesting(tracing.spans(), st.call)
    assert sorted(under["query"]) == ["query.certify", "query.readback", "query.rescore",
                                      "query.rounds"]
    pts, _ = _data()
    tracing.clear()
    fresh = KNNIndex.build(pts, IndexSpec(engine="jit", height=4, devices=(CPU,)))
    fresh.warm(M, K)
    names = {s.name: s for s in tracing.spans()}
    assert {"build", "build.plan", "build.tree", "build.upload", "warm"} <= set(names)
    for child in ("build.plan", "build.tree", "build.upload"):
        assert names[child].parent == names["build"].id
    assert names["warm"].parent == 0 and names["warm"].call != names["build"].call


def test_a_forest_on_two_slots_sums_its_shards(monkeypatch):
    pts, q = _data(n=4000, seed=5)
    index = KNNIndex.build(pts, IndexSpec(engine="forest", height=4, devices=(CPU,) * 2))
    tracing.clear()
    st = index.query(q, K).stats
    shards = [sh.rounds[(M, K + FP32_OVERFETCH)].last for sh in index._state.shards]
    assert st.leaf_visits == sum(w.leaf_visits for w in shards) > 0
    assert st.units_scanned == sum(w.units_scanned for w in shards)
    assert st.useful_pairs == sum(w.useful_pairs for w in shards)
    assert st.steady_rounds == sum(w.executed for w in shards)
    for i, (name, sec) in enumerate(st.phase_s):
        assert name == jitsearch.PHASES[i]
        assert sec == pytest.approx(sum(w.phase_s[i][1] for w in shards))
    # each slot's query steps nest under the facade's query span
    under = _check_nesting(tracing.spans(), st.call)
    assert sorted(under["query"]).count("query.rounds") == 2


def test_spans_of_many_threads_keep_their_own_nesting():
    """16 threads (more than this machine's cores) open nested spans at a
    short switch interval: every span is logged once, with an id of its
    own, and each inner span names its own thread's outer span."""
    import sys
    import threading

    tracing.clear()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)

    def work(n):
        for _ in range(200):
            with tracing.span(f"outer.{n}"):
                with tracing.span(f"inner.{n}"):
                    pass

    try:
        threads = [threading.Thread(target=work, args=(n,)) for n in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    got = tracing.spans()
    assert len(got) == 16 * 200 * 2 and len({s.id for s in got}) == len(got)
    outer = {s.id: s for s in got if s.name.startswith("outer")}
    assert all(s.parent == 0 and s.call == s.id for s in outer.values())
    for s in got:
        if s.name.startswith("inner"):
            mine = outer[s.parent]
            assert mine.name == s.name.replace("inner", "outer") and s.call == mine.id
            assert mine.start_ns <= s.start_ns <= s.end_ns <= mine.end_ns


def test_trace_bounds_pair_each_phase_with_its_kernels_and_stamps():
    """``trace_bounds`` on a hand-made trace of two rounds (ns): a phase's
    kernels' span runs from its first kernel's start to its last's end, its
    stamps' span from the earlier stamp's start to the later one's end;
    a phase with no kernel has an empty span; what lies between rounds (the
    tally, a copy) belongs to no phase; a trace of broken rounds raises."""
    def round_at(t):
        return [("stamp_kernel", t, t + 2), ("advance", t + 3, t + 10), ("adv2", t + 11, t + 20),
                ("stamp_kernel", t + 21, t + 23), ("stamp_kernel", t + 24, t + 26),
                ("scan", t + 30, t + 70), ("stamp_kernel", t + 71, t + 73), ("merge", t + 75, t + 90),
                ("stamp_kernel", t + 91, t + 93), ("tally_kernel", t + 94, t + 99)]

    events = round_at(0) + [("Memcpy DtoH", 100, 104)] + round_at(200)
    inner, outer = trace_bounds(events[::-1])
    np.testing.assert_allclose(inner * 1e9, [[17, 0, 40, 15]] * 2)
    np.testing.assert_allclose(outer * 1e9, [[23, 5, 49, 22]] * 2)
    with pytest.raises(ValueError):
        trace_bounds(events[:-2])
