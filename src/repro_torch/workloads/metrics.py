"""Latency recording for run reports: percentiles, not just means.

A mean hides exactly what saturation makes interesting — the tail.  Every
run report (YCSB closed-loop figures, the open-loop serving sweep) records
per-op latencies through a ``LatencyRecorder`` and reports p50/p95/p99 with a
per-op-type breakdown.

Percentiles use the nearest-rank method (deterministic, no interpolation), so
a fixed seed reproduces every reported digit.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Tuple

PERCENTILES = (50.0, 95.0, 99.0)


def percentile(sorted_vals: List[float], q: float) -> float:
    """Nearest-rank percentile of an ascending-sorted list."""
    if not sorted_vals:
        return float("nan")
    rank = max(1, -(-int(q * len(sorted_vals)) // 100))  # ceil(q*n/100), >= 1
    return sorted_vals[min(rank, len(sorted_vals)) - 1]


def latency_summary_us(latencies_s: Iterable[float]) -> Dict[str, float]:
    """{"n", "mean_us", "p50_us", "p95_us", "p99_us", "max_us"} of latencies
    given in seconds."""
    vals = sorted(latencies_s)
    if not vals:
        return {"n": 0, "mean_us": float("nan"), "p50_us": float("nan"),
                "p95_us": float("nan"), "p99_us": float("nan"),
                "max_us": float("nan")}
    out = {"n": len(vals), "mean_us": round(sum(vals) / len(vals) * 1e6, 2),
           "max_us": round(vals[-1] * 1e6, 2)}
    for q in PERCENTILES:
        out[f"p{q:g}_us"] = round(percentile(vals, q) * 1e6, 2)
    return out


def histogram_summary(hist: Dict[int, int]) -> Dict[str, float]:
    """Summary of an integer-valued histogram ``{value: count}`` (e.g.
    coalesced-batch sizes): n, mean, max and the nearest-rank percentiles —
    computed over the counts, never materializing the expanded samples."""
    total = sum(hist.values())
    if not total:
        return {"n": 0, "mean": float("nan"), "max": float("nan"),
                **{f"p{q:g}": float("nan") for q in PERCENTILES}}
    items = sorted(hist.items())
    out = {"n": total,
           "mean": round(sum(v * c for v, c in items) / total, 2),
           "max": float(items[-1][0])}
    for q in PERCENTILES:
        rank = max(1, -(-int(q * total) // 100))  # ceil(q*n/100), >= 1
        cum = 0
        for v, c in items:
            cum += c
            if cum >= rank:
                out[f"p{q:g}"] = float(v)
                break
    return out


class LatencyRecorder:
    """Accumulates (op kind, latency seconds) samples and summarizes them
    overall and per kind."""

    def __init__(self):
        self.records: List[Tuple[str, float]] = []

    def record(self, kind: str, latency_s: float) -> None:
        self.records.append((kind, latency_s))

    def extend(self, records: Iterable[Tuple[str, float]]) -> None:
        self.records.extend(records)

    def __len__(self) -> int:
        return len(self.records)

    def summary(self) -> Dict[str, Dict[str, float]]:
        """{"all": {...}, "<kind>": {...}} latency summaries (µs)."""
        out = {"all": latency_summary_us(s for _, s in self.records)}
        kinds = sorted({k for k, _ in self.records})
        if len(kinds) > 1:
            for kind in kinds:
                out[kind] = latency_summary_us(s for k, s in self.records
                                               if k == kind)
        return out
