"""Every file the harness finds by name exists, parses and names what
exists: ``BENCHMARK.json``'s cells, configurations, traffic mixes,
generators and per-layer readers."""

import dataclasses
import json
import re

import pytest

from kdbench import catalog

ROOT = catalog.ROOT
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
CONFIGS = sorted(p.stem for p in (ROOT / "kdbench" / "configs").glob("*.json"))
TRAFFIC = sorted(p.stem for p in (ROOT / "kdbench" / "traffic").glob("*.json"))


@pytest.mark.parametrize("name", CONFIGS)
def test_config_parses_and_names_a_generator(name):
    cfg = catalog.load_json(ROOT / "kdbench" / "configs" / f"{name}.json")
    assert cfg["name"] == name
    assert (ROOT / "kdbench" / "data" / f"{cfg['generator']['name']}.py").exists()
    assert cfg["precision"] == "fp32" and cfg["k"] >= 1 and cfg["n"] >= cfg["k"]
    assert set(cfg["check"]) == {"bad_rows", "dist_err", "rank_gap"}
    assert cfg["check"]["bad_rows"] == 0
    assert set(cfg["reduced"]) <= set(cfg)


@pytest.mark.parametrize("name", TRAFFIC)
def test_traffic_parses_and_pins_spec_fields_that_exist(name):
    from repro_torch.api import IndexSpec

    tr = catalog.load_json(ROOT / "kdbench" / "traffic" / f"{name}.json")
    fields = {f.name for f in dataclasses.fields(IndexSpec)}
    assert set(catalog.spec_fields(tr)) <= fields
    assert tr["loop"] == "closed" and tr["clients"] == 1
    assert tr["batch"] >= tr["check_rows"] > 0
    IndexSpec(**catalog.spec_fields(tr))


def test_traffic_with_an_unknown_spec_field_is_refused():
    with pytest.raises(ValueError, match="unknown IndexSpec fields"):
        catalog.spec_fields({"spec": {"engnie": "jit"}})


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves(cell):
    c = catalog.load_cell(cell)
    assert {m["name"] for m in c.end_to_end} == {"knn_qps", "peak_mem_gb", "setup_s"}
    assert len(c.end_to_end) == 3 and c.per_layer
    for m in c.per_layer:
        assert callable(catalog.reader(c, m["name"]))


def test_benchmark_json_keeps_to_its_contract():
    assert BENCH["command"] == ["python3", "kdbench/run.py"] and BENCH["paths"] == ["kdbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert all(NAME.match(n) for n in names)
    assert len(set(names)) == len(names)
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        assert c["file"] == f"kdbench/configs/{c['name']}.json"
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
        # every cell a per-layer metric lists reports the metric it moves
        moved = next(x for x in BENCH["end_to_end"] if x["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))
        assert (ROOT / "kdbench" / "metrics" / f"{m['name']}.py").exists()
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
