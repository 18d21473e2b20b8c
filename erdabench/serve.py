"""The serving driver: closed-loop batches through the program's
``ServeEngine``, each request batch handed to ``generate`` when the last one
returned (the only batching the engine has).

Spans are taken from the benchmark's side: the model object and the page
store handed to the engine are wrapped, and so is the CRC kernel's wrapper
(``kernels.ops.crc32_batch``) during resumes, to hold each verdict against
zlib.  Time to first token ends at the first call into ``decode_step`` or
``snapshot_cache`` after ``prefill``: ``generate`` has synced the first token
to the host by then.

A mix with ``preempt`` preempts every batch once, at a decode step drawn
from the seed, and resumes it through the engine's own ``crash_at`` path,
each batch on a page store of its own sized by ``launch.serve.page_store_for``.
Steps come in antithetic pairs (c, lo + hi - c): every pair decodes as many
tokens, takes as many snapshots and restores as much, so every seed does
the same work in another order, and a unit of the window is a pair.
"""
from __future__ import annotations

import collections
import gc
import time
from types import SimpleNamespace
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from erdabench import cell as cells
from erdabench import weights
from erdabench.reading import Reading
from erdabench.reference import model as ref_model
from erdabench.reference.pages import DictPages, zlib_rows
from erdabench.stats import percentile

#: wrapped call -> the host segment it opens
SEGMENT_OF = {"prefill": "prefill", "decode_step": "decode",
              "snapshot_cache": "snapshot", "put_page": "snapshot",
              "restore_cache": "restore", "get_page": "restore"}


def leaves(tree, prefix: str = "") -> List[Tuple[str, torch.Tensor]]:
    """(path, tensor) of every leaf, dict keys in sorted order; ``None``
    holds no leaf, as in the program's page store (a hybrid's cache without
    an ssm tail)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k], f"{prefix}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in leaves(v, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def map_tree(fn, tree):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tree(fn, v) for v in tree)
    return fn(tree)


def nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for _p, t in leaves(tree))


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def settle() -> None:
    """End of set-up: collect what it left and move the survivors out of
    the collector's reach, so that no pass over set-up's objects lands in
    the window at a random time."""
    gc.collect()
    gc.freeze()


def crash_plan(mix: Dict, rng: np.random.Generator) -> List[Optional[int]]:
    """The preemption step of each batch of one unit: an antithetic pair
    (c, lo + hi - c) in an order drawn from the seed; [None] without
    preemption."""
    pre = mix.get("preempt")
    if not pre:
        return [None]
    lo, hi = pre["steps"]
    low = [c for c in range(lo, (lo + hi) // 2 + 1)
           if c not in pre["exclude"] and lo + hi - c not in pre["exclude"]]
    c = int(rng.choice(low))
    return [c, lo + hi - c] if rng.random() < 0.5 else [lo + hi - c, c]


class Recorder:
    """Host spans of the wrapped calls of the batch in flight, its time to
    first token, the resumes, and the page checks."""

    def __init__(self, dev):
        self.dev = dev
        self.calls: List[Tuple[str, float, float, int]] = []
        self.starts: List[Tuple[str, float]] = []
        self.t_batch = 0.0
        self.ttft: Optional[float] = None
        self.resume_t0: Optional[float] = None
        self.resumes: List[float] = []
        self.put = DictPages()
        self.page_mismatches = 0
        self.crc_calls = collections.deque(maxlen=8)

    def begin(self) -> None:
        self.calls, self.starts = [], []
        self.t_batch, self.ttft = time.perf_counter(), None

    def segments(self, t_end: float) -> List[Tuple[str, float, float]]:
        ends = [t for _n, t in self.starts[1:]] + [t_end]
        return [(SEGMENT_OF[n], t0, t1) for (n, t0), t1 in zip(self.starts, ends)]

    def wrap(self, name: str, fn, after=None):
        def call(*args):
            t0 = time.perf_counter()
            if name != "prefill" and self.ttft is None:
                self.ttft = t0 - self.t_batch
            self.starts.append((name, t0))
            out = fn(*args)
            if after is not None:
                sync(self.dev)
            t1 = time.perf_counter()
            size = after(args, out) if after is not None else 0
            self.calls.append((name, t0, t1, size))
            return out
        return call

    def check(self, seq: int, got: Dict[str, Optional[torch.Tensor]]) -> None:
        missing = sum(v is None for v in got.values())
        self.page_mismatches += missing + self.put.mismatches(
            seq, {k: v for k, v in got.items() if v is not None})

    # ------------------------------------------------------------ page store
    def on_snapshot(self, args, out) -> int:
        seq, cache = args
        for path, leaf in leaves(cache):
            self.put.put(seq, path, leaf)
        return nbytes(cache)

    def on_put_page(self, args, out) -> int:
        seq, name, _idx, page = args
        page = torch.from_numpy(np.array(page, copy=True))
        self.put.put(seq, name, page)
        return page.numel() * page.element_size()

    def on_restore(self, args, out) -> int:
        if out is None:
            self.check(args[0], {"cache": None})
            return 0
        self.check(args[0], dict(leaves(out)))
        return nbytes(out)

    def on_get_page(self, args, out) -> int:
        seq, name = args[0], args[1]
        if name == "__tokens__" and self.resume_t0 is not None:
            self.resumes.append(time.perf_counter() - self.resume_t0)
            self.resume_t0 = None
        self.check(seq, {name: None if out is None else out.cpu()})
        return 0 if out is None else out.numel() * out.element_size()

    def wrap_pages(self, pages):
        restore = self.wrap("restore_cache", pages.restore_cache, self.on_restore)

        def restore_cache(*args):
            self.resume_t0 = time.perf_counter()
            return restore(*args)
        pages.snapshot_cache = self.wrap("snapshot_cache", pages.snapshot_cache,
                                         self.on_snapshot)
        pages.put_page = self.wrap("put_page", pages.put_page, self.on_put_page)
        pages.restore_cache = restore_cache
        pages.get_page = self.wrap("get_page", pages.get_page, self.on_get_page)
        return pages

    def wrap_crc(self, fn):
        def crc32_batch(words):
            out = fn(words)
            if self.resume_t0 is not None:
                self.crc_calls.append((words, out))
            return out
        return crc32_batch


def nvm_written(pages) -> int:
    return sum(s.dev.stats.bytes_written for s in pages.store.cluster.servers)


class ServeRun:
    def __init__(self, cell, seed: int, dev, wrap_model=None):
        from repro_torch.configs.base import ModelConfig
        from repro_torch.models import get_model
        self.seed, self.dev = seed, dev
        self.m, self.mix = cell.model, cell.mix
        self.B, self.S = self.mix["batch"], self.mix["prompt_len"]
        self.n_out = self.mix["output_len"]
        self.every = self.mix.get("snapshot_every", 0)
        self.cfg = ModelConfig(**self.m)
        self.family = cells.family_module(self.m)
        self.params = self.family.make_params(self.m, seed, dev)
        self.prompts_of = weights.token_stream(seed, self.m["vocab_size"], dev)
        self.rng = np.random.default_rng(seed)
        self.rec = Recorder(dev)
        model = get_model(self.cfg, dev)
        served = SimpleNamespace(**vars(model))
        served.prefill = self.rec.wrap("prefill", model.prefill)
        served.decode_step = self.rec.wrap("decode_step", model.decode_step)
        self.model = wrap_model(served) if wrap_model is not None else served
        self.shared = None if self.every else self.engine()
        self.reading = Reading(model=self.m, mix=self.mix)
        self.reading.counters.update(nvm_bytes=0, page_bytes=0)
        #: (prompts, served tokens, ttft s) of every batch of the window
        self.batches: List[Tuple[torch.Tensor, np.ndarray, float]] = []

    def engine(self):
        from repro_torch.launch.serve import page_store_for
        from repro_torch.serving import ServeEngine
        pages = None
        if self.every:
            pages = self.rec.wrap_pages(page_store_for(
                self.cfg, self.B, self.S, self.n_out, self.every, self.dev))
        return ServeEngine(self.model, self.params, page_store=pages,
                           snapshot_every=self.every, device=self.dev)

    def warm_up(self) -> None:
        """This cell's shapes once: prefill, decode and, with snapshots, a
        snapshot and a resume."""
        self.rec.begin()
        eng = self.shared or self.engine()
        eng.generate({"tokens": self.prompts_of(self.B, self.S)}, min(self.n_out, 4),
                     crash_at=1 if self.mix.get("preempt") else None)
        sync(self.dev)
        self.rec.resumes.clear()
        self.rec.page_mismatches = 0

    def unit(self, plan, traced: bool = False) -> List[Tuple[str, float, float]]:
        """Serve one unit of batches; returns its host segments."""
        segs = []
        for seq, (prompts, crash_at) in enumerate(plan):
            eng = self.shared or self.engine()
            nvm0 = nvm_written(eng.pages) if self.every else 0
            self.rec.begin()
            out = eng.generate({"tokens": prompts}, self.n_out, seq_id=seq,
                               crash_at=crash_at)
            t_end = time.perf_counter()
            self.batches.append((prompts, out, self.rec.ttft))
            segs.extend(self.rec.segments(t_end))
            if not traced:
                self.reading.calls.extend(self.rec.calls)
                if self.every:
                    c = self.reading.counters
                    c["nvm_bytes"] += nvm_written(eng.pages) - nvm0
                    c["page_bytes"] += sum(s for n, _a, _b, s in self.rec.calls
                                           if n in ("snapshot_cache", "put_page"))
        return segs

    def plan(self):
        return [(self.prompts_of(self.B, self.S), c) for c in crash_plan(self.mix, self.rng)]

    def traced_unit(self) -> None:
        """One unit under the profiler, before the window: its segments,
        trace and kernel launch shapes feed the device metrics.  A trace
        that lost a marker is thrown away and the next unit traced, three
        at most."""
        from erdabench import trace as tr
        from repro_torch.kernels import ops
        for _ in range(3):
            plan = self.plan()
            ops.reset_counts()
            profile, segs = tr.traced(lambda: self.unit(plan, traced=True))
            if profile is not None:
                self.reading.profile, self.reading.traced_segments = profile, segs
                self.reading.counters["flash_shapes"] = dict(
                    ops.COUNTS["flash_attention"].shapes)
                self.reading.counters["crc_shapes"] = dict(ops.COUNTS["crc32_batch"].shapes)
                return

    def window(self, seconds: float) -> float:
        """Units of batches, a new one while the window is open; it closes
        at the end of the unit in flight."""
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds or not self.batches:
            self.reading.segments.extend(self.unit(self.plan()))
        sync(self.dev)
        return time.perf_counter() - t0

    # ------------------------------------------------------------ the checks
    def sample(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """Prompts (R, P) and served tokens (R, n) of the requests the
        check takes, drawn from the seed."""
        rows = [(b, r) for b in range(len(self.batches)) for r in range(self.B)]
        k = min(len(rows), self.mix["check_requests"])
        pick = np.random.default_rng([self.seed, 1]).choice(len(rows), k, replace=False)
        prompts = torch.stack([self.batches[rows[i][0]][0][rows[i][1]] for i in pick])
        served = torch.stack([torch.from_numpy(np.asarray(
            self.batches[rows[i][0]][1][rows[i][1]])) for i in pick]).to(prompts.device)
        return prompts, served

    def logit_gaps(self, prompts, served, precision: str = "fp32") -> Dict[str, float]:
        """The gap by which each served token's reference logit lies below
        the reference's best at its position: the widest (``logit_gap``)
        and the mean over all served tokens (``logit_gap_mean``).  With
        ``precision`` "fp8" the served tokens are those the float8
        reference puts first at the same positions (the control)."""
        fam = self.family
        ref_model.no_tf32()
        logits = fam.served_logits(fam.Reference(self.m), self.params, prompts, served)
        if precision != "fp32":
            low = fam.served_logits(fam.Reference(self.m, precision),
                                    self.params, prompts, served)
            served = torch.stack([lg.argmax(-1) for lg in low])
        gaps = torch.cat([lg.max(-1).values - lg.gather(-1, tok[:, None].long())[:, 0]
                          for lg, tok in zip(logits, served)])
        return {"logit_gap": float(gaps.max()), "logit_gap_mean": float(gaps.mean())}

    def crc_mismatches(self) -> Tuple[int, int]:
        """(rows, rows whose kernel CRC differs from zlib's) over the CRC
        launches of the window's last resumes."""
        rows = bad = 0
        for words, out in self.rec.crc_calls:
            want = zlib_rows(words)
            got = [int(x) for x in out.cpu().tolist()]
            rows += len(want)
            bad += sum(a != b for a, b in zip(got, want))
        return rows, bad


def run(cell, seed: int, seconds: float, trace: bool, dev, t_process: float,
        wrap_model=None) -> Dict:
    from repro_torch.kernels import ops
    sr = ServeRun(cell, seed, dev, wrap_model)
    crc = ops.crc32_batch
    ops.crc32_batch = sr.rec.wrap_crc(crc)
    try:
        sr.warm_up()
        settle()
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        setup_s = time.perf_counter() - t_process
        if trace:
            sr.traced_unit()
            sr.batches.clear()
        window_s = sr.window(seconds)
        peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    finally:
        ops.crc32_batch = crc
    sr.shared = None
    ttfts = sorted(t for _p, out, t in sr.batches for _ in range(out.shape[0]))
    tokens = sum(out.size for _p, out, _t in sr.batches)
    e2e = {"setup_s": setup_s,
           "ttft_p95_ms": percentile(ttfts, 95.0) * 1e3,
           "output_tokens_per_s": tokens / window_s}
    prompts, served = sr.sample()
    values = sr.logit_gaps(prompts, served)
    if sr.every:
        rows, bad = sr.crc_mismatches()
        values["page_diff"] = sr.rec.page_mismatches
        values["crc_diff"] = bad
        values["crc_rows"] = rows
        values["resumes"] = len(sr.rec.resumes)
    return {"e2e": e2e, "reading": sr.reading, "values": values,
            "attempted": len(ttfts), "failed": 0, "peak": peak, "window_s": window_s,
            "runner": sr}
