"""Contention-aware replay of captured doorbell traces.

The legacy replay (``fabric.sim.replay_steps``) prices every network leg as a
pure delay, so concurrent clients only ever interfere on the server CPU —
saturation throughput and tail latency of one-sided-heavy schemes are
invisible.  This module replays the *doorbell-level* traces ``SimTransport``
captures through three arbitrated resources per server:

  * **per-QP send queue** (``FifoLock``) — a doorbell chain holds its QP for
    its whole NIC-issue phase; later chains on the same QP wait in posted
    order (head-of-line blocking, metered per QP);
  * **per-NIC link** (1-worker ``Resource``) — the occupancy legs of every
    chain (PCIe doorbell write, per-WQE fetch + DMA, wire bytes, per-CQE
    delivery) serialize on the shared link, FIFO across all QPs of the NIC.
    Propagation (``t_prop_*``) is pure delay and pipelines freely;
  * **NVM persistence engine** (1-worker ``Resource``) — see below.

Completion vs persistence ("Correct, Fast Remote Persistence", 1909.02092;
"RDMA and the Completion Fallacy", 2603.04774): a write WR **completes** when
the NIC acks — the client may continue — but the data is **durable** only
after its NVM media-write leg drains through the persistence engine.  The
replay therefore finishes an op's process at completion (that is what latency
percentiles measure) while the persist legs run on as background NVM
occupancy; ``OpHandle.durable_at - completed_at`` is the durability lag the
run report surfaces.  (The legacy closed-form pricing charges the media write
on the client path — the conservative paper-calibration view; this module is
where the two legs genuinely separate.)

Uncontended, a single-WR chain prices EXACTLY like the legacy steps — the
occupancy legs are carved out of the calibrated RTTs, never added on top
(see ``pricing.SimParams.t_prop_*``) — so the paper-validation averages
(Erda read ≈ 62 µs, baseline read ≈ 92 µs) reproduce unchanged with
arbitration enabled.  A chain of k WRs pays (k-1) extra WQE+CQE slots, the
per-message NIC cost doorbell batching cannot amortize.
"""
from __future__ import annotations

from typing import Dict, Generator, List, Optional

from repro_torch.netsim.pricing import (ClientCompute, DoorbellEvent, DoorbellTrace,
                                  ServerAsync, SimParams)
from repro_torch.netsim.sim import FifoLock, Resource, Simulator


class ServerPort:
    """One server's contended resources: the NIC link, the CPU cores, and the
    NVM persistence engine (a cluster gets one port per shard)."""

    def __init__(self, sim: Simulator, p: SimParams, name: str = "srv"):
        self.sim = sim
        self.p = p
        self.name = name
        self.nic = Resource(sim, 1, f"{name}.nic")
        self.cpu = Resource(sim, p.server_cores, f"{name}.cpu")
        self.nvm = Resource(sim, 1, f"{name}.nvm")
        self.persist_legs = 0

    def stats(self, horizon_s: float) -> dict:
        return {"name": self.name,
                "nic_utilization": round(self.nic.utilization(horizon_s), 4),
                "cpu_utilization": round(self.cpu.utilization(horizon_s), 4),
                "nvm_utilization": round(self.nvm.utilization(horizon_s), 4),
                "persist_legs": self.persist_legs}


class OpHandle:
    """Completion/durability bookkeeping for one replayed op.

    ``completed_at`` is set by the driver's done-callback; ``durable_at``
    advances as the op's persist legs drain (an op with no persisting writes
    is durable at completion)."""
    __slots__ = ("completed_at", "durable_at", "_outstanding")

    def __init__(self):
        self.completed_at: Optional[float] = None
        self.durable_at: Optional[float] = None
        self._outstanding = 0

    def complete(self, now: float) -> None:
        self.completed_at = now
        if self._outstanding == 0 and self.durable_at is None:
            self.durable_at = now

    def persist_lag_s(self) -> float:
        if self.completed_at is None or self.durable_at is None:
            return 0.0
        return max(0.0, self.durable_at - self.completed_at)


class QPServiceEstimator:
    """Per-QP service-time statistics driving SLO-aware admission: an EMA of
    the QP's drain interval per service unit (the serving layer's unit is one
    dispatched doorbell batch), plus a closed-form latency floor.

    The caller feeds it inter-completion gaps, and ONLY while the QP is
    continuously busy (the previous completion landed after this unit's
    dispatch) — that gap is how fast the pipeline actually drains.  Two
    tempting alternatives are both wrong: the raw dispatch→completion span
    double-counts queueing (the span already includes waiting behind
    in-flight units, and the feasibility estimate multiplies by the
    outstanding count again), shedding nearly everything at saturation; and
    after-idle spans are latency samples (~the 60µs RTT, not a drain cost),
    which inflate the rate EMA at low load and cause spurious shedding.

    The estimate separates the *rate* term from the *latency* term:
    ``now + units_ahead * per_unit_s + floor_s``.  ``per_unit_s`` is the
    drain EMA (seeded from NIC occupancy, the serialized resource that
    bounds drain); ``floor_s`` is the uncontended completion latency of one
    op (propagation pipelines, so it is paid once, not per queued unit).
    Working in batch units rather than per-op rates also sidesteps a Jensen
    trap: completions arrive in bursts, and an EMA over alternating tiny and
    huge per-op gaps lands far from the aggregate drain rate, while the
    batch-gap EMA degrades gracefully.  The serving report surfaces the
    stats so the estimator is inspectable."""
    __slots__ = ("per_unit_s", "floor_s", "alpha", "observations",
                 "min_s", "max_s")

    def __init__(self, seed_s: float, floor_s: float = 0.0,
                 alpha: float = 0.25):
        self.per_unit_s = seed_s
        self.floor_s = floor_s
        self.alpha = alpha
        self.observations = 0
        self.min_s = seed_s
        self.max_s = seed_s

    def observe(self, gap_s: float) -> None:
        self.per_unit_s = (1 - self.alpha) * self.per_unit_s \
            + self.alpha * gap_s
        self.observations += 1
        self.min_s = min(self.min_s, gap_s)
        self.max_s = max(self.max_s, gap_s)

    def estimate_completion_s(self, now_s: float, units_ahead: int,
                              floor_s: Optional[float] = None) -> float:
        """Estimated completion time of a request with ``units_ahead``
        dispatched-but-incomplete units in front of it on this QP: drain the
        pipeline at the observed rate, then one uncontended service.
        ``floor_s`` overrides the seeded latency floor per call — an op kind
        with a different verb pipeline (a replicated write vs a read) has a
        different uncontended floor on the same QP."""
        return now_s + units_ahead * self.per_unit_s \
            + (self.floor_s if floor_s is None else floor_s)

    def stats(self) -> dict:
        return {"per_unit_us": round(self.per_unit_s * 1e6, 3),
                "floor_us": round(self.floor_s * 1e6, 3),
                "observations": self.observations,
                "min_us": round(self.min_s * 1e6, 3),
                "max_us": round(self.max_s * 1e6, 3)}


def replay_doorbells(trace: List[DoorbellEvent], qp: FifoLock, port: ServerPort,
                     op: Optional[OpHandle] = None) -> Generator:
    """Turn one op's captured doorbell trace into a contended DES process.

    Per doorbell chain: acquire the QP (posted order), occupy the shared NIC
    link for the chain's occupancy legs, release the QP (the send queue is
    free once the chain is on the wire), then pipeline propagation / server
    CPU / response legs.  Persist legs are scheduled on the NVM engine as the
    payload lands and complete in the background (durability ≠ completion)."""
    p = port.p
    for ev in trace:
        if isinstance(ev, ClientCompute):
            yield ("delay", ev.seconds)
            continue
        if isinstance(ev, ServerAsync):
            port.cpu.request(ev.seconds, lambda: None)
            continue
        assert isinstance(ev, DoorbellTrace)
        one = [w for w in ev.wrs if w.one_sided]
        two = [w for w in ev.wrs if not w.one_sided]
        if one:
            occ = p.t_nic_doorbell_s + sum(p.t_nic_wqe_s + w.xfer_s
                                           for w in one)
            yield ("lock", qp)
            yield ("acquire", port.nic, occ)
            yield ("unlock", qp)
            # payload is on the wire: schedule durability legs now
            for w in one:
                if w.persist_s:
                    port.persist_legs += 1
                    if op is not None:
                        op._outstanding += 1

                        def _durable(op=op):
                            op._outstanding -= 1
                            if op._outstanding == 0 and op.completed_at is not None:
                                op.durable_at = port.sim.now

                        port.nvm.request(w.persist_s, _durable)
                    else:
                        port.nvm.request(w.persist_s, lambda: None)
            yield ("delay", p.t_prop_one_sided_s)
            yield ("delay", len(one) * p.t_cq_entry_s)
        if two:
            yield ("lock", qp)
            yield ("acquire", port.nic,
                   sum(p.t_nic_wqe_s + w.xfer_s for w in two))
            yield ("unlock", qp)
            yield ("delay", p.t_prop_req_s)
            for w in two:
                yield ("acquire", port.cpu, w.cpu_s)
            yield ("acquire", port.nic,
                   sum(p.t_nic_wqe_s + w.resp_xfer_s for w in two))
            yield ("delay", p.t_prop_resp_s)
            yield ("delay", len(two) * p.t_cq_entry_s)


def contended_latency_us(traces: List[List[DoorbellEvent]],
                         p: Optional[SimParams] = None) -> float:
    """Completion time of doorbell traces replayed as concurrent processes
    (one QP each, one shared server port) on an otherwise idle fabric — the
    single-client calibration check for the contended model, and the
    multi-lane analogue of ``overlapped_latency_us``."""
    p = p or SimParams()
    sim = Simulator()
    port = ServerPort(sim, p)
    t_done = [0.0]

    def _finish():
        t_done[0] = max(t_done[0], sim.now)

    from repro_torch.netsim.sim import run_process
    for i, trace in enumerate(traces):
        if not trace:
            continue
        qp = FifoLock(sim, f"qp{i}")
        run_process(sim, replay_doorbells(trace, qp, port), _finish)
    sim.run()
    return t_done[0] * 1e6


def doorbell_trace_latency_us(trace: List[DoorbellEvent],
                              p: Optional[SimParams] = None) -> float:
    """Uncontended completion latency of ONE op's doorbell trace."""
    return contended_latency_us([trace], p)


def trace_nic_occupancy_s(trace: List[DoorbellEvent],
                          p: Optional[SimParams] = None) -> float:
    """Seconds of shared-NIC occupancy one op consumes — 1/occupancy is the
    op's NIC-bound saturation throughput."""
    from repro_torch.netsim.pricing import chain_nic_occupancy_s
    p = p or SimParams()
    return sum(chain_nic_occupancy_s(p, list(ev.wrs)) for ev in trace
               if isinstance(ev, DoorbellTrace))


def qp_stats_summary(qps: Dict[str, FifoLock]) -> dict:
    """Aggregate + per-QP send-queue stats for run reports: how deep the
    queues got and how long chains spent head-of-line blocked."""
    per_qp = {name: qp.stats() for name, qp in qps.items()}
    return {"per_qp": per_qp,
            "max_queue_depth": max((s["max_queue_depth"]
                                    for s in per_qp.values()), default=0),
            "hol_wait_seconds": round(sum(s["wait_seconds"]
                                          for s in per_qp.values()), 9),
            "hol_wait_events": sum(s["wait_events"] for s in per_qp.values())}
