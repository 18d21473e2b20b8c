"""A cell of ``BENCHMARK.json``, found by name: its configuration file, its
traffic mix (``erdabench/mixes/<traffic>.json``), its limits
(``erdabench/limits/<workload>.json``) and the readers of its per-layer
metrics (``erdabench/metrics/<metric>.py``).  A later cell, mix or metric
is a new file and a new entry; nothing here names one."""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass
class Cell:
    name: str
    config: Dict          # the configuration file
    mix: Dict             # the traffic mix file
    limits: Dict          # number compared -> its limit
    end_to_end: List[Dict]
    per_layer: List[Dict]
    root: Path = ROOT

    @property
    def model(self) -> Dict:
        return self.config["model"]


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def load(workload: str, root: Path = ROOT) -> Cell:
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    cfg = next(c for c in bench["configs"] if c["name"] == w["config"])
    bench_dir = root / "erdabench"
    mine = lambda metric: workload in metric.get("workloads", [workload])
    return Cell(name=workload,
                config=load_json(root / cfg["file"]),
                mix=load_json(bench_dir / "mixes" / f"{w['traffic']}.json"),
                limits=load_json(bench_dir / "limits" / f"{workload}.json"),
                end_to_end=[m for m in bench["end_to_end"] if mine(m)],
                per_layer=[m for m in bench["per_layer"] if mine(m)], root=root)


def reader(metric: str, root: Path = ROOT) -> Callable:
    """The ``read(reading)`` function of ``erdabench/metrics/<metric>.py``."""
    path = root / "erdabench" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "erdabench_metric_" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
