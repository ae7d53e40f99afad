"""Everything a run reads, found by the names in ``BENCHMARK.json``.

- a cell (``workloads``): its configuration and its traffic mix;
- a configuration: the JSON file its entry names (``configs/<name>.json``);
- a traffic mix: ``traffic/<name>.json``, read by the driver its ``kind`` names;
- a per-layer metric: the reader ``metrics/<name>.py`` (``read(readout)``);
- the limits of the cell's correctness check: ``limits/<cell>.json``.

A later cell, configuration, mix or metric is new files and new entries:
nothing here changes.
"""

from __future__ import annotations

import importlib.util
import json
import os
from typing import Callable, Dict, Optional

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(BENCH_DIR)


def load(root: str = REPO) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


class Cell:
    """One workload of the manifest with what it names, loaded."""

    def __init__(self, manifest: dict, name: str, root: str = REPO):
        by_name = {w["name"]: w for w in manifest["workloads"]}
        if name not in by_name:
            raise KeyError(f"no workload {name!r}; the manifest has {sorted(by_name)}")
        self.root = root
        self.entry = by_name[name]
        self.name = name
        self.chips = self.entry["chips"]
        cfg = {c["name"]: c for c in manifest["configs"]}[self.entry["config"]]
        self.config = _read_json(os.path.join(root, cfg["file"]))
        self.traffic = _read_json(os.path.join(root, "portbench", "traffic",
                                               self.entry["traffic"] + ".json"))
        limits = os.path.join(root, "portbench", "limits", name + ".json")
        self.limits = _read_json(limits) if os.path.isfile(limits) else {}
        self.end_to_end = [m for m in manifest["end_to_end"] if _reports(m, name)]
        self.per_layer = [m for m in manifest["per_layer"] if _reports(m, name)]


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def metric_reader(name: str, root: str = REPO) -> Callable:
    """``read`` of ``metrics/<name>.py`` (names may hold dots)."""
    path = os.path.join(root, "portbench", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("portbench_metric_" + name.replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def read_metrics(names, readout, root: str = REPO) -> Dict[str, Optional[float]]:
    """Each named reader's number, None where it found nothing to read."""
    return {n: metric_reader(n, root)(readout) for n in names}
