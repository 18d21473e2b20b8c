"""The program's own spans (``repro_torch.tracing``) on the profiler's
clock: the device operations each span launched, the skew between the
host's clock and the profiler's, and the spans the device's idle gaps fall
in.

    python -m erdabench.program_spans --workload <name> --seed <n> --seconds <s>

From the root of a checkout.  It sets a cell up as ``erdabench.run`` does,
turns the program's recorder on, traces one unit with ``torch.profiler``
keeping each device operation's launch time (the CUDA runtime call with
the same correlation id), then runs the window.  The last line of standard
output is one JSON object:

- ``metrics``: the cell's per-layer metrics and those read from the
  program's spans (``SPAN_METRICS``, readers in ``erdabench/metrics/``
  that take a ``SpanReading``);
- ``twins``: each span sum beside the wrapper measurement it shadows, in
  the same run;
- ``info``: ``clock_skew_us``, ``clock_fit``, ``unattributed_device_share``,
  ``idle_by_span`` and ``device_s_by_span`` of the traced unit;
- ``host_s_by_span``: each span name's count, seconds and self seconds
  over the window;
- ``end_to_end``: the window's end-to-end metrics with the recorder on.

With ``--recorder 0`` the recorder stays off, nothing is imported from
``repro_torch.tracing``, and it prints the device operations of one unit
traced by ``erdabench.trace.traced`` instead: a count that a program
without the recorder gives too.  ``erdabench.run`` does not turn the
recorder on; this module is how the program's spans are read on the card.
"""
from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import bisect  # noqa: E402
import collections  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from typing import Dict, Iterable, List, Optional, Sequence, Tuple  # noqa: E402

import torch  # noqa: E402

from erdabench.reading import Reading  # noqa: E402
from erdabench.trace import (ANCHOR, MARK_CYCLES, MARK_KERNEL, TRACE_BURST,  # noqa: E402
                             TRACE_PAD_S, Profile)

#: the per-layer metrics read from the program's spans
SPAN_METRICS = ("decode_cache_copy_share", "moe_dispatch_share", "moe_drop_share",
                "snapshot_nvm_share", "restore_verify_share", "train_update_share")
#: a span's record_function twin may start this far from the span on the
#: anchor's map before the map becomes a least-squares line through all twins
SKEW_LIMIT_US = 200.0
#: (name, on the device, start us, end us, correlation id, user annotation)
Event = Tuple[str, bool, float, float, int, bool]


@dataclasses.dataclass
class SpanReading(Reading):
    #: the window's program spans (``tracing.SpanRecord``)
    spans: List = dataclasses.field(default_factory=list)
    #: the traced unit's program spans
    traced_spans: List = dataclasses.field(default_factory=list)
    #: the program's counters summed over the traced unit
    program_counters: Dict = dataclasses.field(default_factory=dict)
    #: ``clock_report`` of the traced unit
    clock: Dict = dataclasses.field(default_factory=dict)


# ------------------------------------------------------------ span geometry
def merged(intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def covers(union: List[Tuple[float, float]], t: float) -> bool:
    """Whether ``t`` lies in the ``merged`` intervals ``union``."""
    i = bisect.bisect_right(union, (t, float("inf"))) - 1
    return i >= 0 and union[i][0] <= t <= union[i][1]


def intervals(spans, names) -> List[Tuple[float, float]]:
    return merged((s.t0, s.t1) for s in spans if s.name in names)


def innermost(spans) -> Tuple[List[float], List[Optional[str]]]:
    """Breakpoints of the innermost open span: from ``times[i]`` until the
    next breakpoint, the span named ``names[i]`` (None: no span) is the
    innermost one open."""
    events = sorted([(s.t0, 1, i) for i, s in enumerate(spans)]
                    + [(s.t1, 0, i) for i, s in enumerate(spans)])
    stack: List[int] = []
    times: List[float] = []
    names: List[Optional[str]] = []
    for t, start, i in events:
        if start:
            stack.append(i)
        elif stack and stack[-1] == i:
            stack.pop()
        elif i in stack:
            stack.remove(i)
        times.append(t)
        names.append(spans[stack[-1]].name if stack else None)
    return times, names


def name_at(timeline, t: float) -> Optional[str]:
    times, names = timeline
    i = bisect.bisect_right(times, t) - 1
    return names[i] if i >= 0 else None


def seconds_inside(spans, inner: Sequence[str], outer: Sequence[str]) -> float:
    """Host seconds of the spans named ``inner`` that start inside a span
    named ``outer``."""
    union = intervals(spans, outer)
    return sum(s.t1 - s.t0 for s in spans if s.name in inner and covers(union, s.t0))


def span_seconds(spans, names: Sequence[str]) -> float:
    return sum(s.t1 - s.t0 for s in spans if s.name in names)


def host_s_by_span(spans) -> Dict[str, List]:
    """[count, seconds, self seconds (less the spans directly inside)] of
    each span name."""
    inner: Dict[int, float] = collections.defaultdict(float)
    for s in spans:
        if s.parent is not None:
            inner[s.parent] += s.t1 - s.t0
    by: Dict[str, List] = {}
    for s in spans:
        row = by.setdefault(s.name, [0, 0.0, 0.0])
        row[0] += 1
        row[1] += s.t1 - s.t0
        row[2] += s.t1 - s.t0 - inner[s.id]
    return by


# ------------------------------------------------------------- the profile
class LaunchProfile(Profile):
    """A ``Profile`` whose device operations also carry the host second at
    which each was launched: its CUDA runtime call, matched by correlation
    id, or None where no runtime call matched."""

    def __init__(self, kernels, window, launches: List[Optional[float]],
                 clock_line: Tuple[float, float], clock_skew_us: Optional[float] = None,
                 clock_fit: str = "anchor"):
        super().__init__(kernels, window)
        self.launches = launches
        self.clock_line = clock_line      # (slope, shift): profiler us -> host s
        self.clock_skew_us = clock_skew_us
        self.clock_fit = clock_fit

    def launch_times(self) -> List[float]:
        """Each operation's launch time; its device start where none
        matched (it cannot have been launched later than that)."""
        return [a if t is None else t for (_n, a, _b), t in zip(self.kernels, self.launches)]

    def device_s_launched_in(self, spans, names: Sequence[str]) -> float:
        """Device seconds of the operations launched inside a span named in
        ``names``."""
        union = intervals(spans, names)
        return sum(b - a for (_n, a, b), t in zip(self.kernels, self.launch_times())
                   if covers(union, t))

    def device_s_by_span(self, spans, n: int = 16) -> List[List]:
        """Device seconds summed by the innermost program span open at each
        operation's launch ("between_spans" where none was), the ``n``
        largest."""
        timeline = innermost(spans)
        by: Dict[str, float] = collections.defaultdict(float)
        for (_n, a, b), t in zip(self.kernels, self.launch_times()):
            by[name_at(timeline, t) or "between_spans"] += b - a
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def top_ops_by_span(self, spans, names: Sequence[str], n: int = 4) -> Dict[str, List]:
        """The ``n`` costliest device operations (by name, device seconds)
        launched with each of ``names`` the innermost span open."""
        timeline = innermost(spans)
        by: Dict[str, Dict[str, float]] = {k: collections.defaultdict(float) for k in names}
        for (op, a, b), t in zip(self.kernels, self.launch_times()):
            at = name_at(timeline, t) or "between_spans"
            if at in by:
                by[at][op[:80]] += b - a
        return {k: [[op, v] for op, v in sorted(ops.items(), key=lambda kv: -kv[1])[:n]]
                for k, ops in by.items()}

    def unattributed_device_share(self) -> Optional[float]:
        """The share of device seconds whose operations had no runtime
        call: they are attributed by their device start."""
        total = sum(b - a for _n, a, b in self.kernels)
        lost = sum(b - a for (_n, a, b), t in zip(self.kernels, self.launches) if t is None)
        return lost / total if total else None

    def idle_by_span(self, spans, n: int = 10) -> List[List]:
        """Idle seconds of the window split over the innermost program
        span open through each part of each gap ("between_spans" where
        none was), the ``n`` largest."""
        busy = self.busy_intervals()
        w0, w1 = self.window
        edges = [w0] + [x for ab in busy for x in ab] + [w1]
        gaps = [(max(a, w0), min(b, w1)) for a, b in zip(edges[0::2], edges[1::2])]
        times, names = innermost(spans)
        cuts = [w0] + [t for t in times if w0 < t < w1] + [w1]
        by: Dict[str, float] = collections.defaultdict(float)
        for a, b in gaps:
            if b <= a:
                continue
            i = bisect.bisect_right(cuts, a) - 1
            while i + 1 < len(cuts) and cuts[i] < b:
                lo, hi = max(a, cuts[i]), min(b, cuts[i + 1])
                if hi > lo:
                    by[name_at((times, names), lo) or "between_spans"] += hi - lo
                i += 1
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def fit_line(pairs: Sequence[Tuple[float, float]]) -> Tuple[float, float]:
    """Least-squares (slope, intercept) of y on x over ``pairs`` (x, y)."""
    n = len(pairs)
    mx = sum(x for x, _y in pairs) / n
    my = sum(y for _x, y in pairs) / n
    sxx = sum((x - mx) ** 2 for x, _y in pairs)
    slope = sum((x - mx) * (y - my) for x, y in pairs) / sxx if sxx else 0.0
    return slope, my - slope * mx


def twin_pairs(events: Sequence[Event], spans) -> List[Tuple[float, float, float]]:
    """(twin's profiler start in us, and the perf_counter seconds between
    which it opened: the span's ``t_twin``, or its start where the span
    kept none, and its start) of every program span whose record_function
    twin the trace holds, matched by name in order of start; a name whose
    counts differ is left out."""
    opened: Dict[str, List[Tuple[float, float]]] = collections.defaultdict(list)
    for s in spans:
        opened[s.name].append((s.t0 if s.t_twin is None else s.t_twin, s.t0))
    twins: Dict[str, List[float]] = collections.defaultdict(list)
    for name, device, a, _b, _corr, ua in events:
        if ua and not device and name in opened:
            twins[name].append(a)
    pairs = []
    for name, us in twins.items():
        if len(us) == len(opened[name]):
            pairs.extend((u, lo, hi) for u, (lo, hi) in zip(sorted(us), sorted(opened[name])))
    return pairs


def off_by(t: float, lo: float, hi: float) -> float:
    """How far ``t`` lies outside [lo, hi], signed; 0 inside."""
    return t - hi if t > hi else t - lo if t < lo else 0.0


def clock_report(events: Sequence[Event], spans, profile: "LaunchProfile") -> Dict:
    """How the twins sit on the map ``build_profile`` chose: quantiles of
    how far (us) each twin's mapped start lies outside the seconds in which
    it opened, the five worst (name, seconds into the unit, us, signed as
    span minus twin), and the least and the median lag from a twin to the
    first CUDA runtime call after it (us): the runtime's calls are stamped
    by CUPTI, the twins by the profiler's own clock, so a lag under 0 would
    put launches on another clock than the spans."""
    pairs = twin_pairs(events, spans)
    if not pairs:
        return {}
    slope, shift = profile.clock_line
    gaps = sorted((-off_by(slope * us + shift, lo, hi) * 1e6, hi) for us, lo, hi in pairs)
    t_first = min(t for _us, _lo, t in pairs)
    by_t0 = {s.t0: s.name for s in spans}
    q = lambda xs, f: xs[min(len(xs) - 1, int(f * len(xs)))]
    mags = sorted(abs(g) for g, _t in gaps)
    runtime = sorted(a for name, dev, a, _b, _c, ua in events
                     if not dev and not ua and name.startswith("cu"))
    lags = []
    for us, _lo, _hi in pairs:
        i = bisect.bisect_left(runtime, us)
        if i < len(runtime):
            lags.append(runtime[i] - us)
    lags.sort()
    worst = sorted(gaps, key=lambda g: -abs(g[0]))[:5]
    return {"gap_us": [q(mags, f) for f in (0.5, 0.9, 0.99, 1.0)],
            "gap_worst": [[by_t0.get(t), t - t_first, g] for g, t in worst],
            "runtime_lag_us": [q(lags, f) for f in (0.0, 0.5)] if lags else None,
            "line_ppm": (slope / 1e-6 - 1) * 1e6, "twins": len(pairs)}


def build_profile(events: Sequence[Event], t_anchor: float,
                  spans=()) -> Optional[LaunchProfile]:
    """The ``LaunchProfile`` of one session's ``events``; None when the
    trace lost a marker.  The profiler's microseconds map onto
    ``perf_counter`` seconds by the anchor opened at ``t_anchor``, or, where
    a span's twin lies more than ``SKEW_LIMIT_US`` outside the seconds in
    which it opened on that map, by the least-squares line through every
    twin and the middle of those seconds."""
    anchor = next(e for e in events if e[0] == ANCHOR)
    slope, shift = 1e-6, t_anchor - anchor[2] / 1e6
    pairs = twin_pairs(events, spans)
    skew = lambda: max(abs(off_by(slope * us + shift, lo, hi)) for us, lo, hi in pairs) * 1e6
    clock_skew_us, fit = (skew() if pairs else None), "anchor"
    if clock_skew_us is not None and clock_skew_us > SKEW_LIMIT_US and len(pairs) > 1:
        slope, shift = fit_line([(us, (lo + hi) / 2) for us, lo, hi in pairs])
        clock_skew_us, fit = skew(), "least_squares"
    to_s = lambda us: slope * us + shift
    device = [e for e in events if e[1] and not e[5]]
    marks = [e for e in device if MARK_KERNEL in e[0]]
    if len(marks) != 2:
        return None
    first = min(e[2] for e in marks)
    launch_us = {corr: a for name, dev, a, _b, corr, ua in events
                 if not dev and not ua and name.startswith("cu")}
    kept = [e for e in device if MARK_KERNEL not in e[0] and e[2] >= first]
    return LaunchProfile(
        [(n, to_s(a), to_s(b)) for n, _d, a, b, _c, _u in kept],
        (to_s(first), to_s(max(e[3] for e in marks))),
        [None if c not in launch_us else to_s(launch_us[c]) for _n, _d, _a, _b, c, _u in kept],
        (slope, shift), clock_skew_us, fit)


def session_events(prof) -> List[Event]:
    out = []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns() / 1e3
        out.append((e.name(), e.device_type() == torch.autograd.DeviceType.CUDA, start,
                    start + e.duration_ns() / 1e3, e.correlation_id(),
                    bool(e.is_user_annotation())))
    return out


def traced(fn) -> Tuple[List[Event], float, object]:
    """(events, anchor's perf_counter second, result) of one call of ``fn``
    under ``torch.profiler``, bracketed as ``erdabench.trace.traced`` does.
    The anchor's second is the middle of the seconds in which its
    ``record_function`` opened, a warm one (the first in a process also
    initialises the profiler's callbacks), as a span's twin opens between
    its ``t_twin`` and its start."""
    from torch.profiler import ProfilerActivity, profile, record_function
    sink = torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(TRACE_BURST):
            sink.add_(1)
        torch.cuda.synchronize()
        time.sleep(TRACE_PAD_S)
        with record_function(ANCHOR + ".warm"):
            pass
        t_open = time.perf_counter()
        with record_function(ANCHOR):
            t_anchor = (t_open + time.perf_counter()) / 2
        torch.cuda._sleep(MARK_CYCLES)
        out = fn()
        torch.cuda._sleep(MARK_CYCLES)
        torch.cuda.synchronize()
        time.sleep(TRACE_PAD_S)
    return session_events(prof), t_anchor, out


# ------------------------------------------------------------ the drivers
def trace_unit(unit, reading: SpanReading) -> None:
    """One unit under the profiler with the recorder on; a trace that lost
    a marker is thrown away and the next unit traced, three at most."""
    from repro_torch import tracing
    from repro_torch.kernels import ops
    for _ in range(3):
        ops.reset_counts()
        events, t_anchor, segs = traced(unit)
        spans, counters = tracing.take()
        profile = build_profile(events, t_anchor, spans)
        if profile is not None:
            reading.clock = clock_report(events, spans, profile)
            reading.profile, reading.traced_segments = profile, segs
            reading.traced_spans, reading.program_counters = spans, counters
            reading.counters["flash_shapes"] = dict(ops.COUNTS["flash_attention"].shapes)
            reading.counters["crc_shapes"] = dict(ops.COUNTS["crc32_batch"].shapes)
            return


def serve_cell(cell, seed: int, seconds: float, dev, recorder: bool) -> Dict:
    from erdabench import serve
    from repro_torch.kernels import ops
    sr = serve.ServeRun(cell, seed, dev)
    sr.reading = reading = SpanReading(model=cell.model, mix=cell.mix)
    reading.counters.update(nvm_bytes=0, page_bytes=0)
    crc = ops.crc32_batch
    ops.crc32_batch = sr.rec.wrap_crc(crc)
    try:
        sr.warm_up()
        serve.settle()
        setup_s = time.perf_counter() - T_PROCESS
        if not recorder:
            return device_ops(lambda: sr.unit(sr.plan(), traced=True))
        from repro_torch import tracing
        tracing.enable()
        tracing.take()
        plan = sr.plan()
        trace_unit(lambda: sr.unit(plan, traced=True), reading)
        sr.batches.clear()
        window_s = sr.window(seconds)
        reading.spans, _counters = tracing.take()
        tracing.disable()
    finally:
        ops.crc32_batch = crc
    ttfts = sorted(t for _p, out, t in sr.batches for _ in range(out.shape[0]))
    from erdabench.stats import percentile
    e2e = {"setup_s": setup_s, "ttft_p95_ms": percentile(ttfts, 95.0) * 1e3,
           "output_tokens_per_s": sum(out.size for _p, out, _t in sr.batches) / window_s}
    if sr.rec.resumes:
        e2e["resume_mean_ms"] = 1e3 * sum(sr.rec.resumes) / len(sr.rec.resumes)
    return {"end_to_end": e2e, "reading": reading}


def train_cell(cell, seed: int, seconds: float, dev, recorder: bool) -> Dict:
    from erdabench import serve, train
    tr = train.TrainRun(cell, seed, dev)
    tr.reading = reading = SpanReading(model=cell.model, mix=cell.mix)
    tr.first_steps()
    serve.sync(dev)
    serve.settle()
    setup_s = time.perf_counter() - T_PROCESS
    if not recorder:
        return device_ops(lambda: tr.unit(train.TRACE_STEPS))
    from repro_torch import tracing
    tracing.enable()
    tracing.take()
    trace_unit(lambda: tr.unit(train.TRACE_STEPS), reading)
    window_s = tr.window(seconds)
    reading.spans, _counters = tracing.take()
    tracing.disable()
    return {"end_to_end": {"setup_s": setup_s,
                           "train_tokens_per_s": tr.steps * tr.B * tr.S / window_s},
            "reading": reading}


def device_ops(unit) -> Dict:
    """The device operations of one unit traced by the harness's own
    ``trace.traced``, by name."""
    from erdabench import trace
    for _ in range(3):
        profile, _segs = trace.traced(unit)
        if profile is not None:
            names = collections.Counter(n[:120] for n, _a, _b in profile.kernels)
            return {"device_ops": len(profile.kernels), "by_name": dict(names.most_common())}
    return {"device_ops": None}


# ---------------------------------------------------------- what is read
def twins(r: SpanReading) -> Dict[str, Dict[str, float]]:
    """Each span sum beside the wrapper measurement it shadows, over the
    window: the decode step, the prefill to the first token, a snapshot's
    and a restore's MB/s, and the train step."""
    spans, out = r.spans, {}

    def pair(name, wrapper, twin):
        if wrapper and twin is not None:
            out[name] = {"wrapper": wrapper, "twin": twin, "gap": twin / wrapper - 1}

    steps = sum(s.name == "serve.decode" for s in spans)
    if r.count("decode") and steps:
        pair("decode_step_ms", 1e3 * r.seconds("decode") / r.count("decode"),
             1e3 * span_seconds(spans, ("serve.decode", "serve.token")) / steps)
    prefills = sum(s.name == "serve.prefill" for s in spans)
    if r.count("prefill") and prefills:
        pair("prefill_ms", 1e3 * r.seconds("prefill") / r.count("prefill"),
             1e3 * span_seconds(spans, ("serve.prefill", "serve.first_token")) / prefills)
    for name, call, span in (("snapshot_mb_per_s", "snapshot_cache", "pages.snapshot"),
                             ("restore_mb_per_s", "restore_cache", "pages.restore")):
        calls = [(b - a, n) for c, a, b, n in r.calls if c == call]
        mine = [s for s in spans if s.name == span]
        if calls and mine:
            pair(name, sum(n for _t, n in calls) / sum(t for t, _n in calls) / 1e6,
                 sum(s.counts.get("bytes", 0) for s in mine) / span_seconds(mine, (span,)) / 1e6)
    steps = sum(s.name == "train.step" for s in spans)
    if r.count("step") and steps:
        pair("train_step_ms", 1e3 * r.seconds("step") / r.count("step"),
             1e3 * span_seconds(spans, ("train.step",)) / steps)
    return out


def summary(cell, out: Dict) -> Dict:
    """What a run with the recorder on prints, from its driver's ``out``."""
    from erdabench import cell as cells
    r, p = out["reading"], out["reading"].profile
    metrics = {}
    for name in [m["name"] for m in cell.per_layer] + list(SPAN_METRICS):
        value = cells.reader(name, cell.root)(r)
        if value is not None:
            metrics[name] = value
    result = {"metrics": metrics, "twins": twins(r), "end_to_end": out["end_to_end"],
              "counters": r.program_counters, "host_s_by_span": host_s_by_span(r.spans)}
    if p is not None:
        by_span = p.device_s_by_span(r.traced_spans)
        result["info"] = {"clock_skew_us": p.clock_skew_us, "clock_fit": p.clock_fit,
                          "clock": r.clock,
                          "unattributed_device_share": p.unattributed_device_share(),
                          "idle_by_span": p.idle_by_span(r.traced_spans),
                          "device_s_by_span": by_span,
                          "top_ops_by_span": p.top_ops_by_span(
                              r.traced_spans, [k for k, _v in by_span[:4]]),
                          "busy_s": p.busy_s(), "window_s": p.window[1] - p.window[0],
                          "traced_spans": len(r.traced_spans), "device_ops": len(p.kernels)}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--recorder", type=int, choices=(0, 1), default=1)
    args = ap.parse_args(argv)
    from erdabench import cell as cells
    from erdabench import run
    run.prepare_environment()
    cell = cells.load(args.workload)
    if not torch.cuda.is_available():
        print(f"erdabench: {args.workload} needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda:0")
    drive = {"serve": serve_cell, "train": train_cell}[cell.mix["driver"]]
    out = drive(cell, args.seed, args.seconds, dev, bool(args.recorder))
    result = {"workload": args.workload, "seed": args.seed,
              "device": torch.cuda.get_device_name(dev)}
    result.update(summary(cell, out) if args.recorder else out)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    from erdabench.run import pin_hash_seed
    pin_hash_seed("erdabench.program_spans")
    sys.exit(main())
