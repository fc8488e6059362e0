"""Finding a cell's files by name: the cell in ``BENCHMARK.json``, its
configuration ``kdbench/configs/<config>.json``, its traffic mix
``kdbench/traffic/<traffic>.json``, the generator ``kdbench/data/<name>.py``
that the configuration names and each per-layer metric's reader
``kdbench/metrics/<metric>.py``, all under one root (the checkout)."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Dict, List

ROOT = Path(__file__).resolve().parents[1]

# the IndexSpec fields a traffic mix may pin
SPEC_FIELDS = ("engine", "height", "n_chunks", "buffer_size", "tile_q", "precision",
               "memory_budget", "k_hint", "m_hint")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[dict]    # BENCHMARK.json's end-to-end metrics this cell reports
    per_layer: List[dict]     # and its per-layer metrics
    root: Path


def _reports(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, root: Path = ROOT) -> Cell:
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in {root / 'BENCHMARK.json'}: {sorted(cells)}")
    w = cells[name]
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if _reports(m, name) and m["moves"] in reported]
    return Cell(name=name, chips=int(w["chips"]),
                config=load_json(root / "kdbench" / "configs" / f"{w['config']}.json"),
                traffic=load_json(root / "kdbench" / "traffic" / f"{w['traffic']}.json"),
                end_to_end=e2e, per_layer=per_layer, root=root)


def _module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def data(cell: Cell, seed: int):
    """(points, the query batch) of the cell at ``seed``, from the ``make``
    of the generator module the configuration names."""
    cfg, tr = cell.config, cell.traffic
    params = dict(cfg["generator"])
    name = params.pop("name")
    make = _module(cell.root / "kdbench" / "data" / f"{name}.py", f"kdbench_data_{name}").make
    return make(seed % 2 ** 63, int(cfg["n"]), int(cfg["d"]), int(tr["batch"]), **params)


def reader(cell: Cell, metric: str):
    """The ``read`` of a per-layer metric's reader."""
    path = cell.root / "kdbench" / "metrics" / f"{metric}.py"
    return _module(path, "kdbench_metric_" + metric.replace(".", "_").replace("-", "_")).read


def spec_fields(traffic: dict) -> Dict[str, object]:
    """The IndexSpec fields the traffic mix pins (none: the planner's
    default)."""
    pinned = dict(traffic.get("spec", {}))
    unknown = set(pinned) - set(SPEC_FIELDS)
    if unknown:
        raise ValueError(f"traffic pins unknown IndexSpec fields {sorted(unknown)}")
    return pinned
