"""Roofline terms of a step from the dry-run's counts — the port of
``repro/roofline/analysis.py``.

  compute    = FLOPs_total / (chips × peak)
  memory     = bytes_total / (chips × HBM_bw)
  collective = wire_bytes_per_chip / link_bw

The reference reads ``compiled.cost_analysis()`` of the per-device
partitioned module and parses the collectives out of its HLO text; the
port's dry-run (``launch.dryrun``) counts the FLOPs and bytes of each
device's local ops and records every collective it issues as (kind,
per-device payload bytes, group size).  Wire-byte factors per algorithm
(ring), as the reference's: all-reduce 2·(n−1)/n · |payload|,
all-gather/reduce-scatter/all-to-all (n−1)/n · |payload|, collective-permute
1, where the payload is the collective's per-device result.  MODEL_FLOPS =
6·N·D (2·N·D for a decode token) gives the useful-fraction ratio.  The
peaks default to the H100's (``launch.mesh``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Tuple

from repro_torch.launch.mesh import HBM_BW, LINK_BW, PEAK_FLOPS_BF16

KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
         "collective-permute")


def collective_bytes(records: Iterable[Tuple[str, int, int]]) -> Dict[str, float]:
    """Wire bytes per device, by collective kind, with ring-algorithm
    factors; ``records`` are (kind, payload bytes of the per-device result,
    group size).  A record of no bytes is not counted."""
    out = {k: 0.0 for k in KINDS}
    counts: Dict[str, int] = {k: 0 for k in out}
    for kind, payload, n in records:
        if payload == 0:
            continue
        n = max(2, n)
        if kind == "all-reduce":
            wire = 2.0 * (n - 1) / n * payload
        elif kind in ("all-gather", "reduce-scatter", "all-to-all"):
            wire = (n - 1) / n * payload
        else:  # collective-permute
            wire = float(payload)
        out[kind] += wire
        counts[kind] += 1
    out["_counts"] = counts  # type: ignore
    return out


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops_total: float
    hlo_bytes_total: float
    collective_bytes_per_chip: float
    collective_breakdown: Dict[str, float]
    model_flops: float
    compute_s: float
    memory_s: float
    collective_s: float

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def useful_fraction(self) -> float:
        return self.model_flops / self.hlo_flops_total if self.hlo_flops_total else 0.0

    @property
    def roofline_fraction(self) -> float:
        """compute-term share of the critical path ≈ achievable MFU bound,
        scaled by useful flops."""
        crit = max(self.compute_s, self.memory_s, self.collective_s)
        if crit <= 0:
            return 0.0
        return (self.model_flops / self.hlo_flops_total) * (self.compute_s / crit)

    def to_json(self) -> Dict:
        d = dataclasses.asdict(self)
        d.update(dominant=self.dominant, useful_fraction=self.useful_fraction,
                 roofline_fraction=self.roofline_fraction)
        return d


def roofline_terms(*, arch: str, shape: str, mesh_name: str, chips: int,
                   cost: Dict[str, float], records, model_flops: float,
                   peak_flops: float = PEAK_FLOPS_BF16, hbm_bw: float = HBM_BW,
                   link_bw: float = LINK_BW) -> RooflineReport:
    """cost = {"flops", "bytes accessed"} of ONE device's share of the step
    (its local ops); ``records`` its collectives.  Totals are per-device
    counts times ``chips``, as the reference's."""
    flops_dev = float(cost.get("flops", 0.0))
    bytes_dev = float(cost.get("bytes accessed", 0.0))
    coll = collective_bytes(records)
    counts = coll.pop("_counts", {})
    coll_dev = sum(coll.values())
    return RooflineReport(
        arch=arch, shape=shape, mesh=mesh_name, chips=chips,
        hlo_flops_total=flops_dev * chips,
        hlo_bytes_total=bytes_dev * chips,
        collective_bytes_per_chip=coll_dev,
        collective_breakdown={**coll, "counts": counts},
        model_flops=model_flops,
        compute_s=flops_dev / peak_flops,
        memory_s=bytes_dev / hbm_bw,
        collective_s=coll_dev / link_bw,
    )


def _attention_layer_counts(cfg):
    """(n_full_attn_layers, n_window_layers) for cache-flop accounting."""
    if cfg.family == "ssm":
        return 0, 0
    if cfg.family == "hybrid":
        return cfg.n_layers // max(1, cfg.shared_attn_every), 0
    if cfg.attn_pattern == "swa":
        return 0, cfg.n_layers
    if cfg.attn_pattern == "local_global":
        g = cfg.local_per_global + 1
        G = cfg.n_layers // g
        return G, cfg.n_layers - G
    n = cfg.n_layers + (cfg.encoder_layers if cfg.family == "encdec" else 0)
    return n, 0


def model_flops_for(cfg, shape) -> float:
    """Useful model FLOPs: 6·N·D (train) / 2·N·D (prefill); decode adds the
    attention-over-cache term 4·B·H·hd·C per layer (2·N·1 alone ignores the
    dominant per-token work at 32k-500k contexts)."""
    n_active = cfg.active_param_count()
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        return 6.0 * n_active * S * B
    if shape.kind == "prefill":
        return 2.0 * n_active * S * B
    base = 2.0 * n_active * B
    n_full, n_win = _attention_layer_counts(cfg)
    qdim = cfg.n_heads * cfg.head_dim
    attn = 4.0 * B * qdim * (n_full * S + n_win * min(cfg.window or S, S))
    return base + attn
