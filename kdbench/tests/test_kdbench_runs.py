"""Whole runs of the harness on the CPU at a tiny size, in a root of their
own: a configuration and a traffic file dropped there are found by name;
a sound run is correct; the control and each fault that a cell can have,
planted under the timed path, come out not correct.  The harness's look
for a card is skipped by handing it CPU slots."""

import io
import json
import time

import numpy as np
import pytest
import torch

from kdbench import harness
from kdbench.reference import knn_tf32
from kdbench.tests.helpers import tiny_root

CPU = torch.device("cpu")


def run(root, cell="tiny_d10.tiny_batch", *, trace=0, seconds=0.3, chips=1, seed=2 ** 31 + 11):
    out, err = io.StringIO(), io.StringIO()
    rc = harness.main(["--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
                       "--trace", str(trace)],
                      root=root, devices=[CPU] * chips, stdout=out, stderr=err)
    assert rc == 0, err.getvalue()
    lines = err.getvalue().strip().splitlines()
    return json.loads(out.getvalue().strip().splitlines()[-1]), lines


@pytest.mark.parametrize("spec,chips", [({}, 1), ({"engine": "jit"}, 1), ({}, 4)])
def test_a_new_config_and_traffic_are_found_by_name(tmp_path, spec, chips):
    root = tiny_root(tmp_path, n=2 ** 13, spec=spec, chips=chips, config="my_catalogue",
                     traffic="my_mix")
    res, lines = run(root, "my_catalogue.my_mix", chips=chips)
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] >= 256
    # no device: no peak memory
    assert set(res["metrics"]) == {"knn_qps", "setup_s"}
    assert res["device"]["count"] == chips and res["plan"]["engine"] == (
        "forest" if chips == 4 else spec.get("engine", "chunked"))
    # the compared numbers come last on stderr and last in the line
    assert [ln.split("=")[0] for ln in lines[-3:]] == [
        "[kdbench] check bad_rows", "[kdbench] check dist_err", "[kdbench] check rank_gap"]
    assert list(res)[-1] == "checked"


def test_the_traced_run_reports_the_per_layer_metrics(tmp_path):
    res, _ = run(tiny_root(tmp_path, n=2 ** 13), trace=1)
    assert res["correct"] is True
    assert {"build_s", "rounds_per_batch"} <= set(res["metrics"])
    assert "knn_qps" not in res["metrics"]
    assert {"busy_s", "window_s"} <= set(res["device"]) and "breakdown" in res


def _break(monkeypatch, fault):
    """Plant ``fault(result, queries, k, state)`` under the chunked and
    forest engines' query."""
    from repro_torch.api import engines

    for cls in (engines.ChunkedEngine, engines.ForestEngine):
        sound = cls.query

        def query(self, state, queries, k, sound=sound):
            return fault(sound(self, state, queries, k), queries, k, state)

        monkeypatch.setattr(cls, "query", query)


def _altered(res, queries, k, state):
    d, i, st = res
    i = i.copy()
    i[0, -1] = (i[0, -1] + 1) % 2 ** 13       # one id of one row, its distance kept
    return d, i, st


def _half(res, queries, k, state):
    d, i, st = res
    h = d.shape[0] // 2                         # the second half answered as the first
    return np.concatenate([d[:h], d[:h]]), np.concatenate([i[:h], i[:h]]), st


def _unchanged(res, queries, k, state):
    time.sleep(0.05)                            # the round loop's initial lists
    d, i, st = res
    return np.full_like(d, np.inf), np.full_like(i, -1), st


def _no_exchange(res, queries, k, state):
    if not hasattr(state, "shards"):
        return res
    d, i, st = state.shards[0].query(queries, k)   # the lead card's lists alone
    return d, np.where(i >= 0, i + state.offsets[0], -1), st


@pytest.mark.parametrize("fault,chips", [
    (_altered, 1), (_half, 1), (_unchanged, 1), (_no_exchange, 4), (_half, 4)])
def test_a_planted_fault_is_not_correct(tmp_path, monkeypatch, fault, chips):
    root = tiny_root(tmp_path, n=2 ** 13, chips=chips)
    _break(monkeypatch, fault)
    res, lines = run(root, chips=chips)
    assert res["correct"] is False, lines[-3:]


def test_a_farther_neighbour_is_not_correct(tmp_path, monkeypatch):
    from repro_torch.api import engines

    root = tiny_root(tmp_path, n=2 ** 13)
    sound = engines.ChunkedEngine.query

    def query(self, state, queries, k):
        d2, i2, st = sound(self, state, queries, k + 4)
        return (np.concatenate([d2[:, :k - 1], d2[:, -1:]], 1),
                np.concatenate([i2[:, :k - 1], i2[:, -1:]], 1), st)

    monkeypatch.setattr(engines.ChunkedEngine, "query", query)
    res, lines = run(root)
    assert res["correct"] is False
    checked = res["checked"]
    assert checked["bad_rows"]["value"] == 0 and checked["dist_err"]["value"] < 1e-5
    assert checked["rank_gap"]["value"] > checked["rank_gap"]["limit"]


def test_the_control_in_the_programs_place_is_not_correct(tmp_path, monkeypatch):
    from repro_torch.api import engines

    root = tiny_root(tmp_path, n=2 ** 13)
    points = {}
    build = engines.ChunkedEngine.build

    def keep(self, pts, spec, plan):
        points["p"] = torch.from_numpy(np.asarray(pts, np.float32))
        return build(self, pts, spec, plan)

    def control(self, state, queries, k):
        d, i = knn_tf32(points["p"], torch.from_numpy(queries), k)
        return d.numpy(), i.numpy(), engines.SearchStats(iterations=1)

    monkeypatch.setattr(engines.ChunkedEngine, "build", keep)
    monkeypatch.setattr(engines.ChunkedEngine, "query", control)
    res, lines = run(root)
    assert res["correct"] is False, lines[-3:]
    assert res["checked"]["dist_err"]["value"] > res["checked"]["dist_err"]["limit"]


def test_no_card_gives_no_result(tmp_path, monkeypatch):
    root = tiny_root(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out, err = io.StringIO(), io.StringIO()
    rc = harness.main(["--workload", "tiny_d10.tiny_batch", "--seed", "1", "--seconds", "1"],
                      root=root, stdout=out, stderr=err)
    assert rc != 0 and out.getvalue() == "" and "no result" in err.getvalue()


def test_fewer_cards_than_the_cell_asks_for_gives_no_result(tmp_path, monkeypatch):
    root = tiny_root(tmp_path, chips=4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    out, err = io.StringIO(), io.StringIO()
    rc = harness.main(["--workload", "tiny_d10.tiny_batch", "--seed", "1", "--seconds", "1"],
                      root=root, stdout=out, stderr=err)
    assert rc != 0 and out.getvalue() == ""


def test_a_forbidden_module_loaded_gives_no_result(tmp_path, monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "jaxlib", types.ModuleType("jaxlib"))
    out, err = io.StringIO(), io.StringIO()
    rc = harness.main(["--workload", "tiny_d10.tiny_batch", "--seed", "1", "--seconds", "0.1"],
                      root=tiny_root(tmp_path), devices=[CPU], stdout=out, stderr=err)
    assert rc != 0 and out.getvalue() == "" and "jaxlib" in err.getvalue()
