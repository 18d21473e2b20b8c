"""Open-loop serving at load: Poisson arrivals, SLO-aware admission, and
adaptive doorbell coalescing — per client stream or across the client streams
sharing a QP — over the contention-aware DES.

Closed-loop clients (issue, wait, repeat) can never overload a system — their
arrival rate falls as latency rises, so saturation throughput and the p99
tail are invisible.  This driver is **open-loop**: requests arrive by a
Poisson process at a configured *offered load* regardless of how the system
is doing (modeled on MaxText's queue-fed offline-inference driver), pass an
admission stage (see below), and are issued as doorbell chains over the
arbitrated fabric of ``repro_torch.netsim.contention``: per-QP FIFO send queues, a
shared per-NIC link, server CPU, and an NVM persistence engine (completion ≠
durability).

**Adaptive doorbell coalescing** is the optimization the contention model
makes real: under queueing pressure the dispatcher merges admitted requests
into one ``multi_read``/``multi_write`` doorbell batch instead of ringing per
op.  The policy is queue-depth driven with a bounded wait:

  * when a QP slot frees, take the maximal same-kind run at the queue head
    (never reordering a read past a write it could depend on);
  * if the run is shorter than the adaptive target — an EMA of recently
    observed run lengths — and nothing else is queued behind it, wait up to
    ``max_wait_s`` (anchored at the head request's arrival) for more;
  * dispatch the run at the largest captured batch size that fits.

**Shared-QP coalescing** (``share_qp=True``) lifts the merge from per-client
to per-QP: every client stream targeting the same (host, shard) lanes feeds
ONE ``QPScheduler``, which merges the same-kind run *prefixes* of multiple
streams into a single doorbell.  The ordering invariant is per stream: a
batch contains, for each contributing stream, a contiguous prefix of that
stream's FIFO queue (all of one kind), so any dispatch order is a legal
interleaving of the per-stream FIFOs — a read is never reordered past a
write *within any stream*.  The bounded wait is anchored at the OLDEST head
arrival across the streams, and the EMA run-length target is per QP group.
A single stream's runs are capped by its own read/write alternation; pooling
n streams multiplies the mergeable run at the same ``b_max`` — which is
where the next saturation win past per-client coalescing comes from.

**SLO-aware admission** (``slo_s=...``, ``admission="slo"``) replaces the
blunt queue-position drop: every request carries a deadline (arrival +
``slo_s``), and the admission stage sheds the queued request with the
earliest *infeasible* deadline — estimated from the per-QP service-time EMA
(``QPServiceEstimator``, seeded from the closed-form uncontended pricing) —
instead of tail-dropping at ``queue_bound``.  A request that is going to
miss its deadline anyway is shed before it wastes service the still-feasible
requests behind it could use.  Runs with ``slo_s`` set report **goodput**
(completions that met their deadline) alongside raw throughput and drops.

Timing is replayed from doorbell traces captured off the REAL client code
(``SimTransport.take_doorbells``); functional correctness of the coalescing
rule is checked separately by ``validate_schedule``, which replays the exact
dispatched batches against a real functional store — coalescing must change
timing, never results.

Everything is seeded and event-ordering is deterministic, so a fixed
(seed, config) reproduces the run's event trace byte for byte — in every
mode, shared-QP and SLO admission included.
"""
from __future__ import annotations

import dataclasses
import math
from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.netsim.contention import (OpHandle, QPServiceEstimator, ServerPort,
                                     qp_stats_summary, replay_doorbells,
                                     trace_nic_occupancy_s)
from repro_torch.netsim.pricing import DoorbellTrace, SimParams, trace_completion_s
from repro_torch.netsim.sim import FifoLock, Simulator, run_process
from repro_torch.workloads.metrics import (LatencyRecorder, histogram_summary,
                                     latency_summary_us)
from repro_torch.workloads.ycsb import ZipfianGenerator

#: one dispatchable unit: [(lane index, doorbell trace)] — a single-server
#: op is one lane; a cluster multi-op is one lane per touched shard (plus,
#: replicated, one per mirror host), replayed concurrently (each lane's chain
#: rides that lane's QP and host port)
Lanes = List[Tuple[int, list]]

#: {"read"|"write": {batch_size: Lanes}} — captured off the real store code.
#: An optional "meta" key carries capture-time facts about the traced store
#: ({"replication": r, "mirror_wqes": {batch_size: n}}) — the dispatcher uses
#: it for mirror-leg accounting; schedulers must ignore unknown keys when
#: selecting op kinds.
TraceTable = Dict[str, Dict[int, Lanes]]

#: the TraceTable keys that are dispatchable op kinds (anything else is meta)
TRACE_KINDS = ("read", "write")


@dataclasses.dataclass
class OpenLoopConfig:
    offered_kops: float            # total offered load, KOp/s, split per client
    n_clients: int = 4             # independent request streams
    horizon_s: float = 0.04
    coalesce: bool = True          # False = per-op doorbells (the baseline)
    share_qp: bool = False         # True = all streams share one QP per lane,
                                   # coalescing merges runs ACROSS streams
    b_max: int = 16                # largest coalesced batch
    max_wait_s: float = 20e-6      # bounded wait anchored at oldest head arrival
    posted_depth: int = 8          # max dispatched-but-incomplete batches per
                                   # stream's share of its QP
    queue_bound: int = 512         # admission queue bound (admission="queue")
    slo_s: Optional[float] = None  # per-request deadline = arrival + slo_s;
                                   # setting it turns on goodput accounting
    admission: str = "queue"       # "queue" (bound drop) | "slo" (shed by
                                   # earliest infeasible deadline; needs slo_s)
    read_frac: float = 1.0         # KV page fetches by default
    n_keys: int = 512              # keyspace for the zipfian key stream
    seed: int = 0
    collect_trace: bool = False    # record the event trace (determinism tests)
    collect_schedule: bool = False  # record dispatched (kind, keys) batches


class _Stream:
    """One client's request stream: its pre-generated arrivals and its FIFO
    admission queue.  Queued entries are ``(arrival_t, kind, key, seq)`` —
    ``seq`` is the per-stream admission sequence number the legality property
    checks dispatch order against."""

    __slots__ = ("idx", "arrivals", "queue", "next_arrival", "seq")

    def __init__(self, idx: int, arrivals: List[Tuple[float, str, int]]):
        self.idx = idx
        self.arrivals = arrivals
        self.queue: deque = deque()  # (arrival_t, kind, key, seq)
        self.next_arrival = 0
        self.seq = 0


class QPScheduler:
    """The dispatcher for one QP group: one or more client streams feeding
    one set of per-lane QPs.

    Per-client mode builds one scheduler per stream with private QPs (the
    classic layout: every client owns a QP per lane).  Shared-QP mode builds
    ONE scheduler whose streams are all the clients and whose QPs are shared
    per lane — the merge rule then coalesces same-kind run prefixes across
    streams into a single doorbell.  Either way the scheduler owns the
    adaptive run-length target (EMA), the bounded wait anchored at the oldest
    head arrival, the per-QP service-time estimator the SLO admission sheds
    by, and the batch-size / head-wait telemetry the report surfaces."""

    def __init__(self, name: str, sim: Simulator, ports: List[ServerPort],
                 traces: TraceTable, cfg: OpenLoopConfig,
                 streams: List[_Stream], qps: Dict[int, FifoLock],
                 recorder: LatencyRecorder, out: dict, p: SimParams):
        self.name = name
        self.sim = sim
        self.ports = ports
        self.traces = traces
        self.cfg = cfg
        self.streams = streams
        self.qps = qps
        self.recorder = recorder
        self.out = out  # shared run-level accumulators
        self.p = p
        self.log_idx = streams[0].idx if len(streams) == 1 else -1
        # posted_depth is per SCHEDULER, deliberately NOT scaled by the
        # number of streams sharing the QP: a deep shared pipeline would let
        # every arrival dispatch eagerly as a singleton, moving all queueing
        # into the NIC where neither the coalescer nor the SLO admission can
        # see it.  Keeping the backlog in the admission queues is what lets
        # cross-stream runs form (and makes the shared-vs-per-client
        # comparison conservative: shared mode gets 1/n the posted batches).
        self.posted_depth = cfg.posted_depth
        self.in_flight = 0           # dispatched-but-incomplete batches
        self.outstanding_ops = 0     # requests inside those batches
        self.target = 1.0            # adaptive batch target (EMA of run lengths)
        self.service: Optional[QPServiceEstimator] = None
        self.set_traces(traces)
        self.batch_hist: Dict[int, int] = {}
        self.head_waits: List[float] = []  # dispatch_t - oldest head arrival
        self.handles: List[OpHandle] = []
        self._armed_deadline: Optional[float] = None
        self._last_done_t = 0.0  # drain reference for the service estimator

    # --------------------------------------------------------- trace tables
    def set_traces(self, traces: TraceTable) -> None:
        """Install (or swap, mid-run) the captured trace table this scheduler
        replays from.  Online resharding changes the lane layout under a live
        serving run — a grown cluster fans a multi-op over more lanes, a
        shrunk one over fewer — so ``run_open_loop(..., lane_events=...)``
        calls this at the cutover instants.  Batch-size menus, the adaptive
        ``b_max``, the per-kind latency floors, and the mirror-leg meta all
        refresh; the service-rate EMA is kept (first install seeds it from
        the closed-form uncontended pricing) because the QP's drain rate is a
        property of the fabric, which a membership change shifts only
        gradually as the new lane mix takes effect."""
        self.traces = traces
        self.sizes = {kind: sorted(by_b) for kind, by_b in traces.items()
                      if kind in TRACE_KINDS}
        self.b_max = min(self.cfg.b_max,
                         max(max(s) for s in self.sizes.values()))
        self.meta = traces.get("meta", {})
        self.mirror_wqes: Dict[int, int] = self.meta.get("mirror_wqes", {})
        # per-kind latency floor: one op's uncontended completion for THAT
        # kind's verb pipeline — a replicated write's floor (mirror legs +
        # flip) is well above a read's (two dependent fetches), and shedding
        # a write against the read floor would admit infeasible writes
        self.kind_floor = {
            kind: max(trace_completion_s(self.p, tr)
                      for _, tr in traces[kind][min(self.sizes[kind])])
            for kind in self.sizes}
        if self.service is None:
            # rate seed: per-batch occupancy of the busiest NIC lane (the
            # serialized resource that bounds drain); latency floor: one op's
            # uncontended completion — both closed-form, so estimates are
            # deterministic from the very first arrival
            kind0 = "read" if "read" in self.sizes else next(iter(self.sizes))
            b0 = min(self.sizes[kind0])
            seed_s = max(trace_nic_occupancy_s(tr, self.p)
                         for _, tr in traces[kind0][b0])
            self.service = QPServiceEstimator(seed_s, self.kind_floor[kind0])

    # ------------------------------------------------------------- arrivals
    def start(self) -> None:
        for s in self.streams:
            self._schedule_next_arrival(s)

    def _schedule_next_arrival(self, s: _Stream) -> None:
        if s.next_arrival >= len(s.arrivals):
            return
        t, kind, key = s.arrivals[s.next_arrival]
        s.next_arrival += 1
        self.sim.at(t, lambda: self._arrive(s, t, kind, key))

    def _arrive(self, s: _Stream, t: float, kind: str, key: int) -> None:
        self._schedule_next_arrival(s)
        if self.cfg.admission == "queue" and \
                len(s.queue) >= self.cfg.queue_bound:
            self.out["dropped"] += 1
            self._log(s.idx, "drop", kind, 0)
            return
        s.queue.append((t, kind, key, s.seq))
        s.seq += 1
        self._log(s.idx, "arrive", kind, len(s.queue))
        self._kick()

    # ----------------------------------------------------------- dispatcher
    def _busy_streams(self) -> List[_Stream]:
        """Streams with queued work, oldest head (then lowest idx) first —
        the deterministic merge order."""
        return sorted((s for s in self.streams if s.queue),
                      key=lambda s: (s.queue[0][0], s.idx))

    def _available_run(self, busy: List[_Stream]) -> Tuple[str, float, int, bool]:
        """The mergeable run at the heads of the queues: the oldest head's
        kind, its arrival (the bounded-wait anchor), the total same-kind
        prefix length across streams (≤ b_max), and whether waiting could
        grow it (nothing of another kind queued anywhere and run < b_max)."""
        kind = busy[0].queue[0][1]
        head_t = busy[0].queue[0][0]
        total_queued = sum(len(s.queue) for s in busy)
        run = 0
        for s in busy:
            if s.queue[0][1] != kind:
                continue
            for req in s.queue:
                if req[1] != kind or run == self.b_max:
                    break
                run += 1
            if run == self.b_max:
                break
        can_grow = run == total_queued and run < self.b_max
        return kind, head_t, run, can_grow

    def _snap(self, kind: str, n: int) -> int:
        """Largest captured batch size ≤ n."""
        return max(b for b in self.sizes[kind] if b <= n)

    def _shed_infeasible(self) -> None:
        """SLO admission: shed queued requests by earliest infeasible
        deadline.  The earliest deadline in the group is the oldest arrival
        (deadlines are arrival + slo), i.e. the head the dispatcher would
        serve first; if even that one cannot complete by its deadline —
        estimated from the per-QP service-time EMA with every batch already
        dispatched ahead of it — serving it would be wasted work, so it is
        shed and the next-earliest head is considered."""
        slo = self.cfg.slo_s
        while True:
            busy = self._busy_streams()
            if not busy:
                return
            s = busy[0]
            t0, kind, _key, _seq = s.queue[0]
            # the floor is per KIND: a replicated write pays its mirror legs
            # in the uncontended pipeline too, so an infeasible write is
            # recognized — and shed — BEFORE any of its mirror-lane WQEs are
            # posted, not after the primary leg has already burned NIC time
            est = self.service.estimate_completion_s(
                self.sim.now, self.in_flight,
                floor_s=self.kind_floor.get(kind))
            if est <= t0 + slo:
                return
            s.queue.popleft()
            self.out["shed"] += 1
            self.out[f"shed_{kind}s"] = self.out.get(f"shed_{kind}s", 0) + 1
            self._log(s.idx, "shed", kind, len(s.queue))

    def _kick(self) -> None:
        while self.in_flight < self.posted_depth:
            if self.cfg.admission == "slo":
                self._shed_infeasible()
            busy = self._busy_streams()
            if not busy:
                return
            kind, head_t, run, can_grow = self._available_run(busy)
            if self.cfg.coalesce:
                tgt = min(self.b_max, max(1, int(round(self.target))))
                # exact comparison against the same float the wait timer was
                # armed with: past ~1s of sim time an absolute epsilon is
                # smaller than one ulp and a >=-with-slack test can disagree
                # with the timer's own firing time, re-arming forever
                waited = self.sim.now >= head_t + self.cfg.max_wait_s
                if can_grow and run < tgt and not waited:
                    self._arm(head_t + self.cfg.max_wait_s)
                    return
                b = self._snap(kind, run)
                self.target = (0.75 * self.target
                               + 0.25 * min(run, self.b_max))
            else:
                b = 1
            batch = self._pop_batch(kind, b)
            self._dispatch(kind, head_t, batch)

    def _pop_batch(self, kind: str, b: int) -> List[Tuple]:
        """Pop ``b`` requests as same-kind prefixes of the busy streams in
        merge order — each stream contributes a contiguous FIFO prefix, so
        the batch is a legal interleaving of the per-stream orders."""
        batch: List[Tuple] = []
        for s in self._busy_streams():
            while s.queue and s.queue[0][1] == kind and len(batch) < b:
                t, k, key, seq = s.queue.popleft()
                batch.append((t, k, key, s.idx, seq))
            if len(batch) == b:
                break
        return batch

    def _arm(self, deadline: float) -> None:
        if (self._armed_deadline is not None
                and self._armed_deadline <= deadline):
            return
        self._armed_deadline = deadline

        def fire():
            if self._armed_deadline == deadline:
                self._armed_deadline = None
            self._kick()

        self.sim.at(max(deadline, self.sim.now), fire)

    def _dispatch(self, kind: str, head_t: float, batch: List[Tuple]) -> None:
        b = len(batch)
        self.in_flight += 1
        self.outstanding_ops += b
        self.out["batch_hist"][b] = self.out["batch_hist"].get(b, 0) + 1
        self.batch_hist[b] = self.batch_hist.get(b, 0) + 1
        if kind == "write":
            # mirror-leg WQE census: every dispatched write batch posts the
            # mirror WQEs its captured trace carries — a shed write posts
            # none, which is what the admission="slo" regression asserts
            self.out["write_dispatches"] += 1
            self.out["mirror_wqes"] += self.mirror_wqes.get(b, 0)
        self.head_waits.append(self.sim.now - head_t)
        if self.cfg.collect_schedule:
            self.out["schedule"].append((kind, [k for _, _, k, _, _ in batch]))
            self.out["schedule_detail"].append(
                (kind, [(sidx, seq, k) for _, _, k, sidx, seq in batch]))
        self._log(self.log_idx, "dispatch", kind, b)
        lanes = [(lane, tr) for lane, tr in self.traces[kind][b] if tr]
        op = OpHandle()
        self.handles.append(op)
        arrivals = [t for t, _, _, _, _ in batch]
        dispatched_at = self.sim.now
        remaining = [len(lanes)]

        def lane_done():
            remaining[0] -= 1
            if remaining[0] == 0:
                self._op_done(kind, arrivals, dispatched_at, op)

        if not lanes:  # pragma: no cover - captured traces are never empty
            self._op_done(kind, arrivals, dispatched_at, op)
            return
        for lane, tr in lanes:
            run_process(self.sim,
                        replay_doorbells(tr, self.qps[lane],
                                         self.ports[lane], op), lane_done)

    def _op_done(self, kind: str, arrivals: List[float], dispatched_at: float,
                 op: OpHandle) -> None:
        now = self.sim.now
        op.complete(now)
        # rate observations are inter-completion gaps, and only when the QP
        # was continuously busy across the gap (previous completion after
        # this batch's dispatch) — an after-idle span is a latency sample,
        # already covered by the estimator's closed-form floor, and feeding
        # it to the rate EMA would inflate it at low load (see
        # QPServiceEstimator)
        if self._last_done_t >= dispatched_at:
            self.service.observe(now - self._last_done_t)
        self._last_done_t = now
        for t0 in arrivals:
            self.recorder.record(kind, now - t0)
            if self.cfg.slo_s is not None and now <= t0 + self.cfg.slo_s:
                self.out["in_slo"] += 1
        self.out["completed"] += len(arrivals)
        self._log(self.log_idx, "done", kind, len(arrivals))
        self.in_flight -= 1
        self.outstanding_ops -= len(arrivals)
        self._kick()

    def _log(self, idx: int, event: str, kind: str, n: int) -> None:
        if self.cfg.collect_trace:
            self.out["event_trace"].append(
                (round(self.sim.now, 12), idx, event, kind, n))


def poisson_arrivals(cfg: OpenLoopConfig, client: int) -> List[Tuple[float, str, int]]:
    """Deterministic Poisson arrival stream for one client: (time, kind,
    1-based zipfian key) tuples within the horizon."""
    rate = cfg.offered_kops * 1e3 / cfg.n_clients
    rng = np.random.default_rng([cfg.seed, client])
    n_draw = int(math.ceil(rate * cfg.horizon_s * 2)) + 16
    times = np.cumsum(rng.exponential(1.0 / rate, size=n_draw))
    times = times[times < cfg.horizon_s]
    kinds = rng.random(len(times)) < cfg.read_frac
    keys = ZipfianGenerator(cfg.n_keys,
                            seed=cfg.seed * 7919 + client).sample(len(times)) + 1
    return [(float(t), "read" if r else "write", int(k))
            for t, r, k in zip(times, kinds, keys)]


def _table_lane_ids(table: TraceTable) -> set:
    return {lane for kind, by_b in table.items() if kind in TRACE_KINDS
            for lanes in by_b.values() for lane, _ in lanes}


def run_open_loop(traces: TraceTable, cfg: OpenLoopConfig,
                  p: Optional[SimParams] = None,
                  lane_events: Optional[List[Tuple[float, TraceTable]]] = None,
                  background: Optional[List[Tuple[float, int, list]]] = None
                  ) -> dict:
    """Run one open-loop point: offered load → throughput (and goodput when
    an SLO is set), p50/p95/p99 (per op type), drops/sheds, per-QP
    queue-depth / HoL-blocking stats, per-QP-group batch-size histograms and
    head-of-line wait percentiles, NIC/CPU/NVM utilization, and
    completion-vs-durability lag.

    ``lane_events`` models online resharding under a live serving run: a list
    of ``(t_s, TraceTable)`` — at each instant every scheduler swaps to the
    new table (``QPScheduler.set_traces``), gaining or dropping lanes
    mid-run.  Ports and shared QPs are pre-built for the UNION of lane ids
    across all tables, so a lane that appears at a cutover rides fabric
    resources that existed (idle) from t=0 — deterministic event ordering is
    preserved.  ``background`` injects migration traffic: ``(t_s, port_idx,
    doorbell_trace)`` chains replayed on a per-port background QP, so
    resync/copy bytes contend with foreground serving on the NICs they
    actually cross."""
    if cfg.admission not in ("queue", "slo"):
        raise ValueError(f"unknown admission policy {cfg.admission!r}")
    if cfg.admission == "slo" and cfg.slo_s is None:
        raise ValueError("admission='slo' needs slo_s (the deadline)")
    p = p or SimParams()
    sim = Simulator()
    all_lane_ids = set(_table_lane_ids(traces))
    for _, table in (lane_events or ()):
        all_lane_ids |= _table_lane_ids(table)
    lane_ids = sorted(all_lane_ids)
    max_port = max(lane_ids)
    if background:
        max_port = max(max_port, max(pi for _, pi, _ in background))
    ports = [ServerPort(sim, p, f"srv{j}") for j in range(1 + max_port)]
    recorder = LatencyRecorder()
    out = {"completed": 0, "dropped": 0, "shed": 0, "in_slo": 0,
           "write_dispatches": 0, "mirror_wqes": 0,
           "batch_hist": {}, "event_trace": [], "schedule": [],
           "schedule_detail": []}
    streams = [_Stream(i, poisson_arrivals(cfg, i))
               for i in range(cfg.n_clients)]
    if cfg.share_qp:
        qps = {lane: FifoLock(sim, f"qp{lane}") for lane in lane_ids}
        scheds = [QPScheduler("shared", sim, ports, traces, cfg, streams,
                              qps, recorder, out, p)]
    else:
        scheds = [QPScheduler(f"c{s.idx}", sim, ports, traces, cfg, [s],
                              {lane: FifoLock(sim, f"c{s.idx}.qp{lane}")
                               for lane in lane_ids},
                              recorder, out, p)
                  for s in streams]
    for t_s, table in (lane_events or ()):
        def swap(table=table):
            for sch in scheds:
                sch.set_traces(table)
                sch._kick()
        sim.at(t_s, swap)
    bg_done = [0]
    if background:
        bg_qps = {pi: FifoLock(sim, f"bg.qp{pi}")
                  for pi in sorted({pi for _, pi, _ in background})}
        for t_s, pi, tr in background:
            def inject(pi=pi, tr=tr):
                run_process(sim, replay_doorbells(tr, bg_qps[pi], ports[pi]),
                            lambda: bg_done.__setitem__(0, bg_done[0] + 1))
            sim.at(t_s, inject)
    offered = sum(len(s.arrivals) for s in streams)
    for sch in scheds:
        sch.start()
    sim.run(until=cfg.horizon_s)

    qps = {qp.name: qp for sch in scheds for qp in sch.qps.values()}
    handles = [h for sch in scheds for h in sch.handles]
    lags = [h.persist_lag_s() for h in handles
            if h.completed_at is not None and h.durable_at is not None]
    persisting = [l for l in lags if l > 0]
    unpersisted = sum(1 for h in handles
                     if h.completed_at is not None and h.durable_at is None)
    dispatches = sum(out["batch_hist"].values())
    report = {
        "offered_kops": cfg.offered_kops,
        "offered_arrivals": offered,
        "n_clients": cfg.n_clients,
        "coalesce": cfg.coalesce,
        "share_qp": cfg.share_qp,
        "horizon_s": cfg.horizon_s,
        "completed": out["completed"],
        "throughput_kops": round(out["completed"] / cfg.horizon_s / 1e3, 2),
        "dropped": out["dropped"],
        "drop_rate": round(out["dropped"] / max(offered, 1), 4),
        "shed": out["shed"],
        "shed_by_kind": {"read": out.get("shed_reads", 0),
                         "write": out.get("shed_writes", 0)},
        "write_dispatches": out["write_dispatches"],
        "mirror_wqes": out["mirror_wqes"],
        "lane_events": len(lane_events or ()),
        "background_chains": {"injected": len(background or ()),
                              "completed": bg_done[0]},
        "latency": recorder.summary(),
        "dispatches": dispatches,
        "mean_batch": round(out["completed"] / max(dispatches, 1), 2),
        "batch_hist": dict(sorted(out["batch_hist"].items())),
        # per-QP-group coalescing telemetry: how big the merged doorbells got
        # and how long heads waited for them — the EMA target made inspectable
        "coalescing": {"per_qp": {
            sch.name: {"batch_hist": dict(sorted(sch.batch_hist.items())),
                       "batch": histogram_summary(sch.batch_hist),
                       "head_wait_us": latency_summary_us(sch.head_waits),
                       "service": sch.service.stats()}
            for sch in scheds}},
        "qp": qp_stats_summary(qps),
        "ports": [port.stats(cfg.horizon_s) for port in ports],
        "persist": {
            "legs": sum(port.persist_legs for port in ports),
            "ops_with_lag": len(persisting),
            "mean_lag_us": round(float(np.mean(persisting)) * 1e6, 2)
            if persisting else 0.0,
            "max_lag_us": round(max(lags) * 1e6, 2) if lags else 0.0,
            "unpersisted_at_horizon": unpersisted,
        },
    }
    if cfg.slo_s is not None:
        report["slo"] = {
            "slo_us": round(cfg.slo_s * 1e6, 2),
            "admission": cfg.admission,
            "in_slo": out["in_slo"],
            "late": out["completed"] - out["in_slo"],
            "shed": out["shed"],
            "goodput_kops": round(out["in_slo"] / cfg.horizon_s / 1e3, 2),
        }
    if cfg.collect_trace:
        report["event_trace"] = out["event_trace"]
    if cfg.collect_schedule:
        report["schedule"] = out["schedule"]
        report["schedule_detail"] = out["schedule_detail"]
    return report


def event_trace_bytes(report: dict) -> bytes:
    """Canonical serialization of a run's event trace — byte-identical across
    runs with the same seed + config (the DES determinism criterion)."""
    return repr(report["event_trace"]).encode()


def sweep_open_loop(traces: TraceTable, loads_kops: List[float],
                    p: Optional[SimParams] = None,
                    **cfg_kwargs) -> List[dict]:
    """Throughput-vs-offered-load sweep: one ``run_open_loop`` per point."""
    return [run_open_loop(traces,
                          OpenLoopConfig(offered_kops=load, **cfg_kwargs), p)
            for load in loads_kops]


# -------------------------------------------------- functional verification
def validate_schedule(store, schedule: List[Tuple[str, List[int]]],
                      n_keys: int, value_size: int = 128,
                      seed: int = 0) -> dict:
    """Replay a dispatched batch schedule against a REAL functional store.

    Loads every key, then executes the exact (kind, keys) batches the
    dispatcher issued — ``multi_read`` / ``multi_write`` in dispatch order —
    checking every read against the dict model of acknowledged writes.  The
    dispatch order is a legal serialization of the per-client FIFO streams
    (the coalescer — per-client or shared-QP — never reorders within a
    stream, and batches are same-kind runs), so any mismatch is a stale or
    lost read: the count must be zero.

    Returns the read values too, so a property test can assert that the
    coalesced execution returns byte-identical results to a sequential
    (batch-size-1) execution of the same stream."""
    rng = np.random.default_rng(seed)
    load = [(k, rng.bytes(value_size)) for k in range(1, n_keys + 1)]
    store.multi_write(load)
    model = dict(load)
    stale_or_lost = reads = writes = 0
    read_values: List[Optional[bytes]] = []
    for kind, keys in schedule:
        if kind == "read":
            got = store.multi_read(keys)
            read_values.extend(got)
            reads += len(keys)
            for k, g in zip(keys, got):
                if g != model.get(k):
                    stale_or_lost += 1
        else:
            items = [(k, rng.bytes(value_size)) for k in keys]
            store.multi_write(items)
            model.update(items)
            writes += len(keys)
    return {"dispatches": len(schedule), "reads": reads, "writes": writes,
            "stale_or_lost": stale_or_lost, "read_values": read_values}


def check_schedule_legality(schedule_detail: List[Tuple[str, list]],
                            n_streams: int) -> dict:
    """Check that a dispatched schedule is a legal interleaving of the
    per-stream FIFOs: flattened in dispatch order, every stream's admission
    sequence numbers appear strictly increasing (shed requests may leave
    gaps, but order is never violated), and every batch is same-kind with
    each stream contributing a contiguous run.  Returns the violation count
    (must be zero) plus per-stream dispatch counts."""
    last_seq = {i: -1 for i in range(n_streams)}
    violations = 0
    per_stream = {i: 0 for i in range(n_streams)}
    for kind, entries in schedule_detail:
        seen_streams: List[int] = []
        for sidx, seq, _key in entries:
            if seq <= last_seq[sidx]:
                violations += 1  # reordered within a stream
            last_seq[sidx] = seq
            per_stream[sidx] += 1
            if sidx not in seen_streams:
                seen_streams.append(sidx)
            elif seen_streams[-1] != sidx:
                violations += 1  # a stream's contribution is not contiguous
    return {"violations": violations, "per_stream": per_stream}


# ------------------------------------------- KV page-fetch trace capture
#: per-shard geometry for page-trace capture (small: traces only depend on
#: verb sizes, not device capacity)
_PAGE_CAPTURE_BATCHES = (1, 2, 4, 8, 16)


def capture_page_fetch_traces(n_shards: int = 2, vsize: int = 1024,
                              batches: Tuple[int, ...] = _PAGE_CAPTURE_BATCHES,
                              p: Optional[SimParams] = None,
                              replication: int = 1,
                              device="cuda") -> TraceTable:
    """Capture doorbell traces of REAL ``ErdaCluster`` ``multi_read`` /
    ``multi_write`` page ops at each batch size: the per-shard sub-batches of
    one multi-op become that op's concurrent lanes.  This is the trace table
    the KV-page serving driver replays under contention.

    With ``replication>1`` the mirrored write legs appear as extra lanes,
    each mapped to the PORT of the host that physically holds that backup
    replica (shard i's backup j lives on host ``(i+j) % n_shards``) — so at
    load, mirror traffic contends with primary traffic on the shared NICs of
    the hosts it actually lands on, and under ``share_qp=True`` a mirror
    lane rides the SAME shared QP as every other stream's traffic to that
    host.  ``device`` is where the cluster's clients CRC-verify the pages
    they fetch."""
    from repro_torch.core import ServerConfig, make_store
    from repro_torch.fabric.sim import SimTransport
    p = p or SimParams()
    cfg = ServerConfig(device_size=8 << 20, table_capacity=1 << 10,
                       n_heads=1, region_size=1 << 20, segment_size=64 << 10)
    store = make_store("erda-cluster", n_shards=n_shards, cfg=cfg,
                       transport_factory=lambda dev: SimTransport(dev, p),
                       replication=replication, device=device)
    # shard ids need not be contiguous after elastic membership changes, so
    # ports are indexed by POSITION in the sorted id list, and a mirror
    # host's id is mapped through the same table
    pos = {sid: i for i, sid in enumerate(store.shard_ids)}
    lanes = []  # (host port index, transport, is_mirror) per replica lane
    for sid in store.shard_ids:
        g = store.cluster.groups[sid]
        for j, c in enumerate(g.replicas):
            port = pos[sid] if j == 0 else pos[g.replica_hosts[j]]
            lanes.append((port, c.transport, j > 0))
    table: TraceTable = {"read": {}, "write": {}}
    mirror_wqes: Dict[int, int] = {}
    for b in batches:
        keys = list(range(1, b + 1))
        items = [(k, bytes([k % 251]) * vsize) for k in keys]
        # warm: create objects + settle size caches, then drop location hints
        # so the captured read is the cold dependent-read path (the warm
        # speculative path is the read_speculation figure's business)
        store.multi_write(items)
        store.multi_write(items)
        for g in store.cluster.groups:
            for c in g.replicas:
                c.loc_cache.clear()
        for _, t, _m in lanes:
            t.take_steps()
            t.take_doorbells()
        got = store.multi_read(keys)
        if got != [v for _, v in items]:  # must check even under -O
            raise RuntimeError("page-trace capture returned wrong values")
        table["read"][b] = [(s, tr) for s, t, _m in lanes
                            if (tr := t.take_doorbells())]
        store.multi_write(items)
        mirror_wqes[b] = 0
        wlanes = []
        for s, t, m in lanes:
            tr = t.take_doorbells()
            if tr:
                wlanes.append((s, tr))
                if m:
                    mirror_wqes[b] += sum(len(ev.wrs) for ev in tr
                                          if isinstance(ev, DoorbellTrace))
        table["write"][b] = wlanes
        for _, t, _m in lanes:
            t.take_steps()
    table["meta"] = {"replication": replication, "mirror_wqes": mirror_wqes}
    return table


def capture_migration_traces(n_shards: int = 4, n_keys: int = 96,
                             vsize: int = 1024,
                             p: Optional[SimParams] = None,
                             device="cuda") -> List[Tuple[int, list]]:
    """Capture the doorbell chains a REAL online ``add_shard`` migration
    issues: load ``n_keys`` pages into a Sim-backed cluster, drain the
    capture buffers, run the resharding to completion, and collect every
    client lane's migration chain tagged with the host port (position in the
    final sorted shard-id list) it lands on.

    The serving driver injects these via ``run_open_loop(background=...)``
    so resync/copy bytes contend with foreground page fetches on the NICs
    they actually cross — that contention is the bounded throughput dip the
    resharding figure measures.  ``device`` is where the cluster's clients
    CRC-verify what they fetch."""
    from repro_torch.core import ServerConfig, make_store
    from repro_torch.fabric.sim import SimTransport
    p = p or SimParams()
    cfg = ServerConfig(device_size=8 << 20, table_capacity=1 << 10,
                       n_heads=1, region_size=1 << 20, segment_size=64 << 10)
    store = make_store("erda-cluster", n_shards=n_shards, cfg=cfg,
                       transport_factory=lambda dev: SimTransport(dev, p),
                       device=device)
    store.multi_write([(k, bytes([k % 251]) * vsize)
                       for k in range(1, n_keys + 1)])
    for g in store.cluster.groups:
        for c in g.replicas:
            c.transport.take_steps()
            c.transport.take_doorbells()
    store.add_shard()
    pos = {sid: i for i, sid in enumerate(store.shard_ids)}
    chains = []
    for sid in store.shard_ids:
        for c in store.cluster.groups[sid].replicas:
            c.transport.take_steps()
            if (tr := c.transport.take_doorbells()):
                chains.append((pos[sid], tr))
    return chains
