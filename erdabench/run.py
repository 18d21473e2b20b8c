"""Run one cell of the benchmark on the card and print its result.

    python -m erdabench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  With ``--trace 0`` the result's metrics are
the cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics,
read from one unit of the window traced by ``torch.profiler``.  The last
line of standard output is the result, one JSON object; the numbers
compared with the plain reference, each beside its limit, are the last
lines of standard error and the result's last key, ``checks``.  Without a
CUDA card, or with the JAX package or JAX loaded after the window, the run
exits non-zero and prints no result.

Every run takes one string-hash salt (``HASH_SEED``): the program's page
store hashes a ``str`` into each page's key, so the salt picks the shard
that holds each leaf of a snapshot, and with it how many rows, padded to
the widest, a resume's CRC verify reads.  A run started under another salt
starts itself again in the same process under this one, before torch or
the program is imported; set-up still counts from the first start.
"""
from __future__ import annotations

import os
import time

#: the clock at the first start, carried across ``pin_hash_seed``'s exec
#: (``perf_counter`` is the system's monotonic clock, so it carries)
T_PROCESS = float(os.environ.pop("ERDABENCH_T_PROCESS", time.perf_counter()))

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Dict, List  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
#: top-level module names no run may hold: JAX, its libraries, the JAX
#: package of this repository and its benchmark
FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks")
#: ``PYTHONHASHSEED`` of every run: a fixed page layout, so that every run
#: of a cell verifies as many rows a resume (olmo_1b.preempt: 7 a pair,
#: where a salt drawn at random gives 4 to 8)
HASH_SEED = "0"


def pin_hash_seed(module: str) -> None:
    """Replace this process by ``python -m module`` with the same arguments
    under ``PYTHONHASHSEED`` = ``HASH_SEED``, unless it already runs so."""
    if os.environ.get("PYTHONHASHSEED") == HASH_SEED:
        return
    env = dict(os.environ, PYTHONHASHSEED=HASH_SEED, ERDABENCH_T_PROCESS=repr(T_PROCESS))
    sys.stdout.flush()
    sys.stderr.flush()
    os.execve(sys.executable, [sys.executable, "-m", module, *sys.argv[1:]], env)


def forbidden_modules() -> List[str]:
    return sorted({name for name in list(sys.modules)
                   if name.split(".", 1)[0] in FORBIDDEN})


def prepare_environment() -> None:
    """The program's code on the path, every kernel cache inside the
    checkout, and no JAX through a library that would load it."""
    os.environ["USE_FLAX"] = "0"
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
    src = str(ROOT / "src")
    if src not in sys.path:
        sys.path.insert(0, src)


def execute(cell, seed: int, seconds: float, trace: bool, dev, t_process: float,
            **faults) -> Dict:
    """Run ``cell`` on ``dev`` and judge it; returns the result object."""
    import torch
    from erdabench import cell as cells
    from erdabench import serve, train
    driver = {"serve": serve, "train": train}[cell.mix["driver"]]
    out = driver.run(cell, seed, seconds, trace, dev, t_process, **faults)
    reading = out["reading"]
    metrics = {}
    if trace:
        for m in cell.per_layer:
            value = cells.reader(m["name"], cell.root)(reading)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": out["e2e"][m["name"]], "unit": m["unit"]}
    checks = {name: {"value": out["values"][name], "limit": limit}
              for name, limit in cell.limits.items()}
    correct = (out["attempted"] > 0 and out["failed"] == 0
               and all(c["value"] <= c["limit"] for c in checks.values()))
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
              "count": 1, "memory_peak_bytes": out["peak"]}
    result = {"correct": correct, "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics, "device": device}
    profile = reading.profile
    if trace and profile is not None:
        device["busy_s"] = profile.busy_s()
        device["window_s"] = profile.window[1] - profile.window[0]
        result["breakdown"] = {"device_ops": profile.top_ops(10),
                               "idle_gaps": profile.idle_gaps(reading.traced_segments, 10)}
    result["info"] = {k: v for k, v in out["values"].items() if k not in checks}
    result["info"]["window_s"] = out["window_s"]
    result["checks"] = checks          # last: the driver keeps a failed run's end
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    prepare_environment()
    from erdabench import cell as cells
    cell = cells.load(args.workload)
    import torch
    chips = next(w["chips"] for w in cells.load_json(ROOT / "BENCHMARK.json")["workloads"]
                 if w["name"] == args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"erdabench: {args.workload} needs {chips} CUDA card(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}",
              file=sys.stderr)
        return 2
    result = execute(cell, args.seed, args.seconds, bool(args.trace),
                     torch.device("cuda:0"), T_PROCESS)
    found = forbidden_modules()
    if found:
        print(f"erdabench: modules loaded that no run may hold: {found}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r} "
              f"{'ok' if c['value'] <= c['limit'] else 'FAIL'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    pin_hash_seed("erdabench.run")
    sys.exit(main())
