"""A cell of ``BENCHMARK.json``, found by name: its configuration file, its
traffic mix (``erdabench/mixes/<traffic>.json``), its limits
(``erdabench/limits/<workload>.json``), the readers of its per-layer
metrics (``erdabench/metrics/<metric>.py``) and its model family's weights,
reference and operation counts (``erdabench/families/<family>.py``, or the
transformer's).  A later cell, mix, metric or family is a new file and a
new entry; nothing here names one."""
from __future__ import annotations

import dataclasses
import functools
import importlib.util
import json
from pathlib import Path
from types import ModuleType, SimpleNamespace
from typing import Callable, Dict, List, Optional

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


class Model(dict):
    """A configuration's ``model`` dict that knows the tree it was loaded
    from, so that code handed only the dict (``counts``, which the metric
    readers call with ``Reading.model``; the training reference) finds the
    same family module as the drivers."""

    def __init__(self, items: Dict, root: Path = ROOT):
        super().__init__(items)
        self.root = root


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
    config = load_json(root / cfg["file"])
    config["model"] = Model(config["model"], root)
    return Cell(name=workload,
                config=config,
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


#: what a family module defines, each with the transformer's signature:
#: ``make_params(m, seed, device)``, ``Reference(m, precision="fp32")`` with
#: ``.loss(params, tokens)``, ``served_logits(ref, params, prompts, served)``,
#: ``prefill_flops(m, batch, seq)``, ``train_flops(m, batch, seq)``
FAMILY_API = ("make_params", "Reference", "served_logits", "prefill_flops", "train_flops")


def own_family(model: Dict) -> Optional[ModuleType]:
    """``erdabench/families/<model["family"]>.py`` of the tree ``model`` was
    loaded from (``Model.root``; a plain dict: this checkout's), loaded once
    a process; None where the family has no file."""
    family = model.get("family")
    if not family:
        return None
    path = getattr(model, "root", ROOT) / "erdabench" / "families" / f"{family}.py"
    return _load_family(path) if path.is_file() else None


@functools.cache
def _load_family(path: Path) -> ModuleType:
    spec = importlib.util.spec_from_file_location("erdabench_family_" + path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    missing = [name for name in FAMILY_API if not hasattr(mod, name)]
    if missing:
        raise AttributeError(f"{path} defines no {', '.join(missing)}")
    return mod


def family_module(model: Dict):
    """What the drivers make and judge a configuration's model with.

    A family with a file, ``erdabench/families/<family>.py``, brings its own
    (``FAMILY_API``): ``make_params`` the program's weight tree for the
    family, made on the device from the seed; ``Reference``, whose
    ``precision="fp8"`` is the control, and ``served_logits``, plain PyTorch
    that imports nothing of the program (``repro_torch``), of ``repro`` or of
    JAX, as ``erdabench/reference/`` does; the FLOP counts behind
    ``prefill_mfu`` and ``train_mfu``, which ``counts`` hands to it.
    ``weights.token_stream`` and ``reference.model.no_tf32`` stay shared.  A
    family without a file (``dense``, ``moe``) gets the transformer's:
    ``weights.make_params``, ``reference.model.Reference`` and
    ``served_logits``, ``counts.prefill_flops`` and ``train_flops``."""
    own = own_family(model)
    if own is not None:
        return own
    from erdabench import counts, weights
    from erdabench.reference import model as ref_model
    return SimpleNamespace(make_params=weights.make_params, Reference=ref_model.Reference,
                           served_logits=ref_model.served_logits,
                           prefill_flops=counts.prefill_flops, train_flops=counts.train_flops)
