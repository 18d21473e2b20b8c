"""The training driver: the program's train step (``train.step.
make_train_step`` with ``optim`` AdamW) over batches of uniform tokens drawn
on the device from the seed, every row new.

Set-up builds one train state from the benchmark's weights, drives it
through its first three steps with the window's own call and feed, reads
the program's numbers there (each step's loss, the first gradient as the
optimizer took it — its first moment over 1 - b1 — and each leaf's change
after the three), and hands that same state to the window.  The loss is
read to the host after every step, as the program's launcher does.
"""
from __future__ import annotations

import statistics
import time
from typing import Dict, List, Tuple

import torch

from erdabench import cell as cells
from erdabench import weights
from erdabench.reading import Reading
from erdabench.reference import adamw as ref_adamw
from erdabench.reference import model as ref_model
from erdabench.serve import leaves, map_tree, settle, sync

#: steps the reference follows
CHECKED_STEPS = 3
#: steps the traced run profiles
TRACE_STEPS = 2


def norms(tensors) -> List[float]:
    return [float(torch.linalg.vector_norm(t.float())) for t in tensors]


def gaps(prog: List[float], ref: List[float], keep=None) -> float:
    """The worst leaf's gap between the program's norm and the
    reference's, over the larger of the reference's norm of that leaf and
    of the median leaf."""
    idx = [i for i in range(len(ref)) if keep is None or keep[i]]
    med = statistics.median(ref[i] for i in idx)
    return max(abs(prog[i] - ref[i]) / max(ref[i], med) for i in idx)


class TrainRun:
    def __init__(self, cell, seed: int, dev, wrap_step=None):
        from repro_torch.configs.base import ModelConfig
        from repro_torch.models import get_model
        from repro_torch.optim import AdamWConfig, adamw_init
        from repro_torch.train.step import make_train_step
        self.m, self.mix, self.dev = cell.model, cell.mix, dev
        self.B, self.S = self.mix["batch"], self.mix["seq_len"]
        model = get_model(ModelConfig(**self.m), dev)
        step = make_train_step(model, AdamWConfig(**self.mix["adamw"]))
        self.step_fn = wrap_step(step) if wrap_step is not None else step
        params = cells.family_module(self.m).make_params(self.m, seed, dev)
        self.state = {"params": params, "opt": adamw_init(params)}
        self.feed = weights.token_stream(seed, self.m["vocab_size"], dev)
        self.reading = Reading(model=self.m, mix=self.mix)
        self.steps = 0

    def step(self) -> float:
        self.state, metrics = self.step_fn(self.state, {"tokens": self.feed(self.B, self.S)})
        return float(metrics["loss"])

    def first_steps(self) -> Dict:
        """The checked steps; returns the program's readings."""
        p0 = [t for _p, t in leaves(self.state["params"])]
        losses = [self.step()]
        b1 = self.mix["adamw"].get("b1", 0.9)
        grad = [n / (1 - b1) for n in norms(t for _p, t in leaves(self.state["opt"]["m"]))]
        losses += [self.step() for _ in range(CHECKED_STEPS - 1)]
        change = norms(p.float() - q.float() for p, q in
                       zip((t for _p, t in leaves(self.state["params"])), p0))
        return {"loss": losses, "grad": grad, "change": change}

    def unit(self, n: int) -> List[Tuple[str, float, float]]:
        segs = []
        for _ in range(n):
            t0 = time.perf_counter()
            self.step()
            t1 = time.perf_counter()
            segs.append(("step", t0, t1))
            self.steps += 1
        return segs

    def traced_unit(self) -> None:
        """``TRACE_STEPS`` steps under the profiler, before the window; a
        trace that lost a marker is thrown away, three at most."""
        from erdabench import trace as tr
        for _ in range(3):
            profile, segs = tr.traced(lambda: self.unit(TRACE_STEPS))
            if profile is not None:
                self.reading.profile, self.reading.traced_segments = profile, segs
                return

    def window(self, seconds: float) -> float:
        t0 = time.perf_counter()
        self.steps = 0
        while time.perf_counter() - t0 < seconds or not self.steps:
            segs = self.unit(1)
            self.reading.segments.extend(segs)
            self.reading.calls.extend((n, a, b, 0) for n, a, b in segs)
        sync(self.dev)
        return time.perf_counter() - t0


def reference_readings(m: Dict, mix: Dict, seed: int, dev, precision: str = "fp32") -> Dict:
    """The plain reference's three steps from the same weights and feed:
    each step's loss, the first clipped gradient's norm and each leaf's
    change after the three, by leaf."""
    fam = cells.family_module(m)
    ref_model.no_tf32()
    ref = fam.Reference(m, precision)
    tree = fam.make_params(m, seed, dev)
    p0 = [t for _p, t in leaves(tree)]
    params = map_tree(lambda t: t.to(torch.float32, copy=True).requires_grad_(True), tree)
    ps = [t for _p, t in leaves(params)]
    del tree
    feed = weights.token_stream(seed, m["vocab_size"], dev)
    hp = dict(lr=3e-4, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1, grad_clip=1.0)
    hp.update(mix["adamw"])
    mom = [torch.zeros_like(p) for p in ps]
    vel = [torch.zeros_like(p) for p in ps]
    out = {"loss": [], "grad": None, "change": None}
    for s in range(1, CHECKED_STEPS + 1):
        tokens = feed(mix["batch"], mix["seq_len"])
        loss = ref.loss(params, tokens)
        grads = torch.autograd.grad(loss, ps)
        out["loss"].append(float(loss.detach()))
        taken = ref_adamw.adamw_step(hp, [p.data for p in ps], list(grads), mom, vel, s)
        if s == 1:
            out["grad"] = norms(taken)
        del grads, taken, loss
    out["change"] = norms(p.detach() - q.float() for p, q in zip(ps, p0))
    return out


def compare(prog: Dict, ref: Dict) -> Dict[str, float]:
    """The three numbers compared: the worst step's relative loss gap, and
    the worst leaf's gap of the first gradient's norm and of the change's.
    Leaves whose reference gradient is under a thousandth of the median
    leaf's are left out of the change: they move by round-off alone."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(prog["loss"], ref["loss"]))
    med = statistics.median(ref["grad"])
    keep = [g >= 1e-3 * med for g in ref["grad"]]
    return {"loss_gap": loss, "grad_gap": gaps(prog["grad"], ref["grad"]),
            "change_gap": gaps(prog["change"], ref["change"], keep)}


def run(cell, seed: int, seconds: float, trace: bool, dev, t_process: float,
        wrap_step=None) -> Dict:
    tr = TrainRun(cell, seed, dev, wrap_step)
    prog = tr.first_steps()
    sync(dev)
    settle()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.perf_counter() - t_process
    if trace:
        tr.traced_unit()
    window_s = tr.window(seconds)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    steps = tr.steps
    tr.state = tr.step_fn = None
    e2e = {"setup_s": setup_s,
           "train_tokens_per_s": steps * tr.B * tr.S / window_s}
    values = compare(prog, reference_readings(cell.model, cell.mix, seed, dev))
    return {"e2e": e2e, "reading": tr.reading, "values": values,
            "attempted": steps, "failed": 0, "peak": peak, "window_s": window_s,
            "runner": tr, "program": prog}
