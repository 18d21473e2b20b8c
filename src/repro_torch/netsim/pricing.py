"""The ONE pricing table for the simulated fabric.

Every timed path — the hand-composable verb generators in ``netsim.verbs``,
the per-doorbell trace capture in ``fabric.sim``, and the contention-aware
replay in ``netsim.contention`` — prices network legs through this module, so
the paper calibration cannot silently fork between the layers:

  - one-sided RTT ≈ 30 µs  → Erda read (2 one-sided reads) ≈ 62 µs  (paper: 62.84)
  - two-sided read service ≈ 55-60 µs → baseline read ≈ 92 µs       (paper: 92.7)

(2010-era Xeon E5620 + ConnectX-3 numbers, not modern hardware; see
EXPERIMENTS.md §Paper-validation.)

Two views of the same constants:

* **Uncontended (closed-form) legs** — ``chain_steps`` turns one doorbell
  chain into the classic ``("delay"|"cpu", seconds)`` steps: base RTT /
  half-RTT charged once per chain, marginal transfer / NVM persist / CPU
  service per WR.  This is the calibrated single-client pricing every
  existing figure replays.

* **Contended decomposition** — for the arbitration model the base RTTs are
  split into the part that *occupies the NIC* (PCIe doorbell write, per-WQE
  fetch + DMA setup, per-CQE delivery) and pure wire propagation which
  consumes no shared resource.  The split is exact: for a single-WR chain

      t_nic_doorbell_s + t_nic_wqe_s + t_prop_one_sided_s + t_cq_entry_s
        == t_one_sided_s

  so an uncontended op prices identically under both views, while under load
  the occupancy legs queue on the shared per-NIC link (head-of-line blocking)
  and the propagation legs pipeline.  ``netsim.contention`` holds the replay.

The chain cost vocabulary (``WrCost`` / ``DoorbellTrace`` / ``ClientCompute``
/ ``ServerAsync``) is shared between the capture side (``fabric.sim`` records
what the real protocol code did, verb by verb) and both replay sides.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple, Union


@dataclasses.dataclass
class SimParams:
    # network
    t_one_sided_s: float = 30.0e-6        # base RTT for a one-sided verb
    t_half_rtt_s: float = 15.0e-6         # one-way network latency (two-sided legs)
    net_bandwidth_Bps: float = 5.0e9      # 40 Gbps
    # NIC occupancy decomposition (carved OUT of the RTTs above, never added
    # on top — the derived t_prop_* properties keep the uncontended sums
    # exactly equal to the calibrated RTTs)
    t_nic_doorbell_s: float = 1.2e-6      # PCIe doorbell write + chain schedule
    t_nic_wqe_s: float = 0.3e-6           # per-WR WQE fetch + DMA setup
    t_cq_entry_s: float = 0.2e-6          # per-WR CQE delivery + client drain
    # server CPU service components (seconds)
    t_cpu_poll_s: float = 2.0e-6          # receive + dispatch a two-sided message
    t_cpu_hash_s: float = 2.0e-6          # hash-table lookup
    t_cpu_read_base_s: float = 60.0e-6    # baseline read servicing (lookup+copy+post)
    t_cpu_erda_alloc_s: float = 38.0e-6   # Erda write_with_imm: alloc + 8B atomic meta
    t_cpu_redo_append_s: float = 40.0e-6  # redo: receive record, CRC verify, append
    t_cpu_apply_s: float = 10.0e-6        # async apply from log/ring to destination
    t_cpu_raw_alloc_s: float = 20.0e-6    # RAW: ring slot allocation + response
    # client CPU
    crc_bandwidth_Bps: float = 2.0e9      # client-side CRC verification
    memcpy_bandwidth_Bps: float = 4.0e9
    # server parallelism (2 × 4-core Xeon E5620)
    server_cores: int = 8

    def xfer_s(self, nbytes: int) -> float:
        return nbytes / self.net_bandwidth_Bps

    def crc_s(self, nbytes: int) -> float:
        return nbytes / self.crc_bandwidth_Bps

    def memcpy_s(self, nbytes: int) -> float:
        return nbytes / self.memcpy_bandwidth_Bps

    # ------------------------------------------- derived propagation residues
    @property
    def t_prop_one_sided_s(self) -> float:
        """Wire propagation of a one-sided chain: the calibrated RTT minus the
        occupancy legs charged once per chain (doorbell) / once per WR."""
        return (self.t_one_sided_s - self.t_nic_doorbell_s - self.t_nic_wqe_s
                - self.t_cq_entry_s)

    @property
    def t_prop_req_s(self) -> float:
        """Propagation of the two-sided request half-RTT."""
        return self.t_half_rtt_s - self.t_nic_wqe_s

    @property
    def t_prop_resp_s(self) -> float:
        """Propagation of the two-sided response half-RTT."""
        return self.t_half_rtt_s - self.t_nic_wqe_s - self.t_cq_entry_s


# ----------------------------------------------------- chain cost vocabulary
@dataclasses.dataclass(frozen=True)
class WrCost:
    """Resource footprint of ONE work request, independent of any backend:
    wire transfer seconds, server-CPU seconds (two-sided only), and the NVM
    persistence leg (durability — deliberately separate from completion)."""
    one_sided: bool
    xfer_s: float                 # request/payload wire occupancy
    resp_xfer_s: float = 0.0      # response wire occupancy (two-sided)
    cpu_s: float = 0.0            # server CPU service incl. poll (two-sided)
    persist_s: float = 0.0        # NVM media write — durability, NOT completion


@dataclasses.dataclass(frozen=True)
class DoorbellTrace:
    """One doorbell ring: the chain of WRs posted on one QP lane."""
    qp: int
    wrs: Tuple[WrCost, ...]


@dataclasses.dataclass(frozen=True)
class ClientCompute:
    """Client-side compute between doorbells (e.g. CRC verification)."""
    seconds: float


@dataclasses.dataclass(frozen=True)
class ServerAsync:
    """Background server-CPU work (e.g. applying a redo entry): consumes CPU
    capacity, never blocks the issuing client."""
    seconds: float


DoorbellEvent = Union[DoorbellTrace, ClientCompute, ServerAsync]

Step = Tuple[str, float]  # ("delay"|"cpu"|"cpu_async", seconds)


# ----------------------------------------------- uncontended (legacy) pricing
def chain_steps(p: SimParams, wrs: List[WrCost]) -> List[Step]:
    """Price one doorbell chain as calibrated closed-form steps: base legs
    ONCE per chain, marginal legs per WR.

    * the one-sided WRs of the chain share ONE base round trip
      (``t_one_sided_s``), then each pays its marginal transfer and, for
      persisting writes, its NVM media write;
    * the two-sided WRs share ONE request half-RTT and ONE response half-RTT,
      while every WR pays its own wire transfers and its own server-CPU
      service (the CPU never batches).

    A single-WR chain therefore prices exactly like the classic blocking verb
    — the paper-calibration numbers are unchanged — while a chain of k WRs
    amortizes the fixed RTT k ways."""
    one = [w for w in wrs if w.one_sided]
    two = [w for w in wrs if not w.one_sided]
    steps: List[Step] = []
    if one:
        steps.append(("delay", p.t_one_sided_s))
        for w in one:
            steps.append(("delay", w.xfer_s))
            if w.persist_s:
                steps.append(("delay", w.persist_s))
    if two:
        steps.append(("delay", p.t_half_rtt_s))
        for w in two:
            steps.append(("delay", w.xfer_s))
            steps.append(("cpu", w.cpu_s))
            steps.append(("delay", w.resp_xfer_s))
        steps.append(("delay", p.t_half_rtt_s))
    return steps


def quorum_times_s(lane_times: List[Tuple[float, float]],
                   quorum: int) -> Tuple[float, float]:
    """Quorum ack / durability points over per-replica lane times.

    ``lane_times`` holds one ``(completed_s, durable_s)`` pair per replica
    lane of a mirrored write.  The write is *acknowledged* when the
    ``quorum``-th lane completes and *durable* when the ``quorum``-th lane's
    NVM persist lands — order statistics over the two lists independently
    (the quorum-th completion and the quorum-th persist need not be the same
    replica).  With r=2 and W=2 this degenerates to the LATER replica on both
    axes, which is the pricing rule the replication figure asserts."""
    if not lane_times:
        raise ValueError("quorum_times_s needs at least one lane")
    if not 1 <= quorum <= len(lane_times):
        raise ValueError(
            f"quorum {quorum} out of range for {len(lane_times)} lanes")
    completed = sorted(t[0] for t in lane_times)
    durable = sorted(t[1] for t in lane_times)
    return completed[quorum - 1], durable[quorum - 1]


def chain_completion_s(p: SimParams, wrs: List[WrCost]) -> float:
    """Client-visible completion time of ONE doorbell chain on an otherwise
    idle fabric, under the contended decomposition: occupancy legs + wire
    propagation + (serialized) server CPU + CQE drain.  This is the closed
    form of what ``netsim.contention.replay_doorbells`` prices when nothing
    queues, and it is deliberately independent of how many *streams*
    contributed WRs to the chain — a shared-QP doorbell that merges several
    clients' runs prices exactly like the same chain posted by one client.
    For a single-stream chain the regression tests pin this against the DES
    replay, so cross-client merging can never drift the pricing table."""
    one = [w for w in wrs if w.one_sided]
    two = [w for w in wrs if not w.one_sided]
    t = 0.0
    if one:
        t += p.t_nic_doorbell_s + sum(p.t_nic_wqe_s + w.xfer_s for w in one)
        t += p.t_prop_one_sided_s + len(one) * p.t_cq_entry_s
    if two:
        t += sum(p.t_nic_wqe_s + w.xfer_s for w in two)
        t += p.t_prop_req_s
        t += sum(w.cpu_s for w in two)
        t += sum(p.t_nic_wqe_s + w.resp_xfer_s for w in two)
        t += p.t_prop_resp_s + len(two) * p.t_cq_entry_s
    return t


def trace_completion_s(p: SimParams, events: List["DoorbellEvent"]) -> float:
    """Uncontended completion time of a whole doorbell trace: chains and
    client compute serialize on the client path; ``ServerAsync`` work is
    background CPU and costs the client nothing.  Used to SEED the per-QP
    service-time EMA the SLO-aware admission stage sheds by, so feasibility
    estimates are defined from the very first arrival (deterministically)
    rather than only after the first completion."""
    t = 0.0
    for ev in events:
        if isinstance(ev, ClientCompute):
            t += ev.seconds
        elif isinstance(ev, DoorbellTrace):
            t += chain_completion_s(p, list(ev.wrs))
    return t


def chain_nic_occupancy_s(p: SimParams, wrs: List[WrCost]) -> float:
    """Seconds one doorbell chain occupies the shared NIC link — the quantity
    that bounds saturation throughput under contention (the propagation and
    CPU legs pipeline; these do not)."""
    one = [w for w in wrs if w.one_sided]
    two = [w for w in wrs if not w.one_sided]
    occ = 0.0
    if one:
        occ += p.t_nic_doorbell_s + sum(p.t_nic_wqe_s + w.xfer_s for w in one)
    if two:
        occ += sum(p.t_nic_wqe_s + w.xfer_s for w in two)
        occ += sum(p.t_nic_wqe_s + w.resp_xfer_s for w in two)
    return occ
