"""A checkout-like root in a temporary directory for the harness's CPU
tests: ``BENCHMARK.json`` with tiny cells, their configuration and
traffic files, and the repository's generators and readers."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from kdbench import catalog

REPO = catalog.ROOT


def tiny_root(tmp: Path, *, n: int = 4096, batch: int = 256, spec=None, chips: int = 1,
              config: str = "tiny_d10", traffic: str = "tiny_batch", check_rows: int = 64) -> Path:
    """A root holding one cell ``<config>.<traffic>``: the repository's
    catalogue at ``n`` points, batches of ``batch`` queries."""
    for sub in ("data", "metrics"):
        shutil.copytree(REPO / "kdbench" / sub, tmp / "kdbench" / sub, dirs_exist_ok=True)
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    cfg = json.loads((REPO / "kdbench" / "configs" / "sdss_psf_d10.json").read_text())
    cfg.update(name=config, n=n, cards=chips)
    tr = json.loads((REPO / "kdbench" / "traffic" / "batch_jit.json").read_text())
    tr.update(batch=batch, spec=spec or {}, check_rows=check_rows)
    for sub, name, body in (("configs", config, cfg), ("traffic", traffic, tr)):
        (tmp / "kdbench" / sub).mkdir(parents=True, exist_ok=True)
        (tmp / "kdbench" / sub / f"{name}.json").write_text(json.dumps(body))
    cell = f"{config}.{traffic}"
    bench["configs"] = [{"name": config, "source": "https://arxiv.org/abs/1512.02831",
                         "file": f"kdbench/configs/{config}.json", "reduced": ["n"],
                         "why": "a tiny catalogue for the CPU tests"}]
    bench["workloads"] = [{"name": cell, "config": config, "traffic": traffic, "chips": chips,
                           "why": "a tiny cell for the CPU tests"}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [cell]
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp
