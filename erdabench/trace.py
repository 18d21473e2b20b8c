"""The traced slice of a ``--trace 1`` run: a ``torch.profiler`` session over
one unit of work, and what the per-layer readers take from it.

Each session launches and waits for 256 throwaway kernels first and pads
0.25 s: once the card has idled, a session loses the device events of its
first milliseconds, and these kernels absorb the loss (``chip_smoke.py``'s
``trace_session``, copied).  Spin kernels bracket the work; a trace that
lost one of them lost device events of the work and is not used.

Host spans are taken on ``time.perf_counter``; one ``record_function``
anchor, opened at a known host time, maps them onto the profiler's clock.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import torch

TRACE_BURST = 256
TRACE_PAD_S = 0.25
MARK_KERNEL = "spin_kernel"
MARK_CYCLES = 1000
ANCHOR = "erdabench.anchor"


class Profile:
    """Device intervals of one traced slice, in host seconds."""

    def __init__(self, kernels: List[Tuple[str, float, float]], window: Tuple[float, float]):
        self.kernels = kernels      # (name, start_s, end_s), markers left out
        self.window = window        # (first marker's start, last marker's end)

    def busy_intervals(self) -> List[Tuple[float, float]]:
        merged: List[List[float]] = []
        for _n, a, b in sorted(self.kernels, key=lambda k: k[1]):
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return [(a, b) for a, b in merged]

    def busy_s(self, spans: Optional[List[Tuple[float, float]]] = None) -> float:
        """Seconds in which a device operation ran, within ``spans`` where
        given, else within the traced window."""
        spans = spans if spans is not None else [self.window]
        total = 0.0
        busy = self.busy_intervals()
        for s0, s1 in spans:
            for a, b in busy:
                total += max(0.0, min(b, s1) - max(a, s0))
        return total

    def device_s(self, needle: str) -> float:
        """Summed device seconds of the operations whose name holds
        ``needle``."""
        return sum(b - a for n, a, b in self.kernels if needle in n)

    def top_ops(self, n: int = 10) -> List[List]:
        by: Dict[str, float] = {}
        for name, a, b in self.kernels:
            by[name[:120]] = by.get(name[:120], 0.0) + (b - a)
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, segments: List[Tuple[str, float, float]], n: int = 10) -> List[List]:
        """The ``n`` longest stretches of the window in which the device ran
        nothing, each named by the host segment its midpoint fell in."""
        busy = self.busy_intervals()
        w0, w1 = self.window
        edges = [w0] + [x for ab in busy for x in ab] + [w1]
        gaps = [(max(a, w0), min(b, w1)) for a, b in zip(edges[0::2], edges[1::2])]
        gaps = sorted((g for g in gaps if g[1] > g[0]), key=lambda g: g[0] - g[1])[:n]
        out = []
        for a, b in gaps:
            mid = (a + b) / 2
            name = next((s for s, t0, t1 in segments if t0 <= mid < t1), "between_units")
            out.append([name, b - a])
        return out


def _events(prof):
    """(name, is_device, start_us, end_us) of every event of the session,
    read from the profiler's raw results: building its ``FunctionEvent``
    tree takes minutes for a unit of a hundred thousand kernels."""
    out = []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns() / 1e3
        out.append((e.name(), e.device_type() == torch.autograd.DeviceType.CUDA,
                    start, start + e.duration_ns() / 1e3))
    return out


def traced(fn) -> Tuple[Optional[Profile], object]:
    """(``Profile`` of one call of ``fn``, its result); the profile is None
    when the trace lost a marker."""
    from torch.profiler import ProfilerActivity, profile, record_function
    sink = torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(TRACE_BURST):
            sink.add_(1)
        torch.cuda.synchronize()
        time.sleep(TRACE_PAD_S)
        t_anchor = time.perf_counter()
        with record_function(ANCHOR):
            pass
        torch.cuda._sleep(MARK_CYCLES)
        out = fn()
        torch.cuda._sleep(MARK_CYCLES)
        torch.cuda.synchronize()
        time.sleep(TRACE_PAD_S)
    events = _events(prof)
    anchor = next(e for e in events if e[0] == ANCHOR)
    shift = t_anchor - anchor[2] / 1e6                   # profiler us -> host s
    device = [e for e in events if e[1]]
    marks = [e for e in device if MARK_KERNEL in e[0]]
    if len(marks) != 2:
        return None, out
    first = min(e[2] for e in marks)
    to_s = lambda us: us / 1e6 + shift
    kernels = [(n, to_s(a), to_s(b)) for n, _d, a, b in device
               if MARK_KERNEL not in n and a >= first]
    return Profile(kernels, (to_s(first), to_s(max(e[3] for e in marks)))), out
