"""Readings that set a cell's limits: the program's numbers over many seeds,
and beside them the control's — the plain reference put in the program's
place in float8 e4m3, the precision below the bfloat16 the configurations
state — and, for training, the faults the comparison has to catch.

    python -m erdabench.control --workload <name> --seeds 1,2,3 --seconds 3 [--faults]

One process reads every seed (set-up is long).  Each line of output is one
seed's JSON: ``program`` holds the numbers a run compares, ``control`` the
same numbers of the control, ``faults`` those of each planted fault.  The
benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time

from erdabench import run as bench_run


def half_batch(step):
    """A train step that leaves out half of each batch."""
    def broken(state, batch):
        return step(state, {k: v[: v.shape[0] // 2] for k, v in batch.items()})
    return broken


def unchanged_state(step):
    """A train step that returns its state as it got it."""
    def broken(state, batch):
        _new, metrics = step(state, batch)
        return state, metrics
    return broken


def long_step(step):
    """A train step whose update is half as long again as the optimizer's,
    as with a learning rate 1.5 times the configured one."""
    def broken(state, batch):
        new, metrics = step(state, batch)
        params = zip_map(lambda p, q: (q.float() + 1.5 * (p.float() - q.float())).to(q.dtype),
                         new["params"], state["params"])
        return {"params": params, "opt": new["opt"]}, metrics
    return broken


def no_bias_correction(hp):
    """A train step that updates by AdamW's moments without their bias
    correction (``m / (sqrt(v) + eps)``, not ``mhat / (sqrt(vhat) + eps)``),
    from the program's own moments after the step."""
    from repro_torch.optim import AdamWConfig
    cfg = AdamWConfig(**hp)

    def wrap(step):
        def broken(state, batch):
            new, metrics = step(state, batch)
            upd = lambda p, m, v: (p.float() - cfg.lr * (
                m / (v.sqrt() + cfg.eps) + cfg.weight_decay * p.float())).to(p.dtype)
            params = zip_map(upd, state["params"], new["opt"]["m"], new["opt"]["v"])
            return {"params": params, "opt": new["opt"]}, metrics
        return broken
    return wrap


def zip_map(fn, tree, *others):
    """``fn`` over the leaves of ``tree`` and the same leaves of ``others``."""
    if isinstance(tree, dict):
        return {k: zip_map(fn, v, *(o[k] for o in others)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(zip_map(fn, v, *(o[i] for o in others)) for i, v in enumerate(tree))
    return fn(tree, *others)


def train_faults(hp):
    """Each planted training fault by name: a wrapper of the train step."""
    return {"half_batch": half_batch, "unchanged_state": unchanged_state,
            "long_step": long_step, "no_bias_correction": no_bias_correction(hp)}


def readings(cell, seed: int, seconds: float, dev, faults: bool) -> dict:
    import torch
    from erdabench import serve, train
    t0 = time.perf_counter()
    if cell.mix["driver"] == "serve":
        out = serve.run(cell, seed, seconds, False, dev, t0)
        sr = out["runner"]
        prompts, served = sr.sample()
        line = {"program": out["values"],
                "control": sr.logit_gaps(prompts, served, "fp8")}
    else:
        tr = train.TrainRun(cell, seed, dev)
        prog = tr.first_steps()
        tr.state = None
        del tr
        gc.collect()
        ref = train.reference_readings(cell.model, cell.mix, seed, dev)
        low = train.reference_readings(cell.model, cell.mix, seed, dev, "fp8")
        line = {"program": train.compare(prog, ref), "control": train.compare(low, ref)}
        if faults:
            line["faults"] = {}
            for name, wrap in train_faults(cell.mix["adamw"]).items():
                tr = train.TrainRun(cell, seed, dev, wrap)
                prog = tr.first_steps()
                tr.state = None
                del tr
                gc.collect()
                line["faults"][name] = train.compare(prog, ref)
        out = {"peak": torch.cuda.max_memory_allocated(dev)}
    line["seed"] = seed
    line["peak"] = out["peak"]
    del out
    gc.unfreeze()
    gc.collect()
    torch.cuda.empty_cache()
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--faults", action="store_true")
    args = ap.parse_args(argv)
    bench_run.prepare_environment()
    import torch
    from erdabench import cell as cells
    if not torch.cuda.is_available():
        print("erdabench.control: needs a CUDA card", file=sys.stderr)
        return 2
    cell = cells.load(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        line = readings(cell, seed, args.seconds, torch.device("cuda:0"), args.faults)
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
