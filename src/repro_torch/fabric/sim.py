"""SimTransport — the DES-timed transport backend.

Functionally identical to ``InProcessTransport`` (it executes every verb, so
the *real* ``ErdaClient`` / baseline store code runs over it unchanged), but
every primitive additionally appends calibrated timing steps:

    ("delay", seconds)       client-observed latency (network, NVM persist,
                             client-side CRC verification)
    ("cpu", seconds)         server CPU service the op *waits* for — replayed
                             as a FIFO acquire of the server-CPU resource, so
                             two-sided ops queue when the CPU saturates
    ("cpu_async", seconds)   background server work (e.g. applying a redo
                             entry) — consumes CPU capacity, does not block

Pricing happens **per doorbell**, which is what makes doorbell batching real
in the model.  When the engine rings a doorbell for a chain of posted WRs:

  * the one-sided WRs of the chain share ONE base round-trip
    (``t_one_sided_s`` — PCIe doorbell + NIC fetch + wire RTT for the whole
    posted chain), then each WR pays only its marginal transfer time and, for
    persisting writes, its NVM media write;
  * the two-sided WRs of the chain share ONE request half-RTT and ONE
    response half-RTT, while every WR still pays its own wire transfer and
    its own server-CPU service (the CPU never batches: each RPC is polled,
    dispatched, and serviced individually).

A doorbell carrying a single WR therefore prices *exactly* like the old
call-and-return verb — the paper-calibration numbers (Erda read ≈ 62 µs,
baseline read ≈ 92 µs) are unchanged — while a chain of k WRs amortizes the
fixed RTT k ways, which is the entire win ``batch()`` exists to model.

Doorbells are strictly **per lane**: a ``batch()`` (and its ``fence()``)
rings only the lanes posted within that batch, so each QP's chain is priced
independently.  That is what makes *mirror chains* (the replication layer's
primary + backup write legs, posted on two lanes of two transports inside
the same batch scopes) price as OVERLAPPED: each lane's steps replay as its
own concurrent DES process (``overlapped_latency_us``), and the mirrored
batch completes when the slower lane drains — never as a serialized second
round trip.

The per-op CPU service-time table lives in ``_service`` — ONE place, keyed by
protocol op label, calibrated against the paper's measured averages exactly as
``netsim.verbs`` documents (one-sided RTT ≈ 30 µs → Erda read ≈ 62 µs;
two-sided read service ≈ 55-60 µs → baseline read ≈ 92 µs).

``benchmarks/schemes_des.py`` captures each op's step trace by running the
real store code once, then replays the trace through the event loop for every
closed-loop iteration (``replay_steps``).  The steps are resource-agnostic so
a sharded cluster can replay the same trace against *its* shard's CPU.

Pricing itself lives in ``repro_torch.netsim.pricing`` — ONE shared table: this
backend only classifies each executed WR into a ``WrCost`` (wire transfer,
server-CPU service, NVM persist leg) and lets ``pricing.chain_steps`` emit
the calibrated legs.  Alongside the flat steps it records a **doorbell-level
trace** (``take_doorbells``): the chain structure, per-WR costs, client
compute and background server work, in order — the input the contention-aware
replay (``repro_torch.netsim.contention``) arbitrates over per-QP send queues and
the shared per-NIC link, with completion split from persistence.  Both views
are derived from the same ``WrCost`` objects, so they cannot drift.
"""
from __future__ import annotations

from typing import Generator, List, Optional, Tuple

from repro_torch.fabric.transport import MSG_BYTES, Handle, InProcessTransport
from repro_torch.netsim.pricing import (ClientCompute, DoorbellEvent, DoorbellTrace,
                                  ServerAsync, SimParams, WrCost, chain_steps)
from repro_torch.netsim.sim import Resource
from repro_torch.nvmsim.device import NVMDevice

Step = Tuple[str, float]  # ("delay"|"cpu"|"cpu_async", seconds)


class SimTransport(InProcessTransport):
    def __init__(self, dev: NVMDevice, params: Optional[SimParams] = None, *,
                 trace: bool = False):
        super().__init__(dev, trace=trace)
        self.p = params or SimParams()
        self.steps: List[Step] = []
        self.doorbell_trace: List[DoorbellEvent] = []

    def take_steps(self) -> List[Step]:
        s, self.steps = self.steps, []
        return s

    def take_doorbells(self) -> List[DoorbellEvent]:
        """Drain the doorbell-level trace (chains + client/background work) —
        the contention-aware replay's input."""
        d, self.doorbell_trace = self.doorbell_trace, []
        return d

    # ------------------------------------------------------- CPU service table
    def _service(self, op: str, req_bytes: int, resp_bytes: int) -> float:
        """Server-CPU seconds for a two-sided op — the single calibration point
        for every scheme's CPU involvement."""
        p = self.p
        if op == "erda.write_req":        # alloc + one 8-byte atomic meta flip
            return p.t_cpu_erda_alloc_s
        if op == "erda.write_cleaning":   # §4.4 send path: server copies + persists
            return (p.t_cpu_erda_alloc_s + p.memcpy_s(req_bytes)
                    + self.dev.write_latency_s(req_bytes))
        if op == "erda.read":             # §4.4 send path read
            return p.t_cpu_read_base_s + p.memcpy_s(resp_bytes)
        if op == "erda.repair":           # one lookup + one atomic store
            return p.t_cpu_hash_s
        if op == "redo.write":            # receive, CRC-verify, append to redo log
            return (p.t_cpu_redo_append_s + p.crc_s(req_bytes)
                    + self.dev.write_latency_s(4 + req_bytes))
        if op == "raw.alloc":             # hand out a ring-buffer slot
            return p.t_cpu_raw_alloc_s
        if op in ("redo.read", "raw.read"):  # lookup + copy + post response
            return p.t_cpu_read_base_s + p.memcpy_s(resp_bytes)
        if op in ("redo.apply", "raw.apply"):  # background apply to destination
            return p.t_cpu_apply_s + self.dev.write_latency_s(req_bytes)
        return p.t_cpu_hash_s             # metadata-only ops (e.g. deletes)

    # ------------------------------------------------------ per-doorbell price
    def _wr_cost(self, h: Handle) -> WrCost:
        """Classify one executed WR into the shared chain-cost vocabulary —
        the single place a WR's wire/CPU/persist footprint is decided."""
        wr = h.wr
        p = self.p
        if wr.verb == "one_sided_read":
            return WrCost(True, p.xfer_s(wr.nbytes))
        if wr.verb == "atomic_word_write":
            return WrCost(True, p.xfer_s(8))
        if wr.verb == "one_sided_write":
            # ACK ≠ persistent; the persistence leg is priced separately so
            # the contended replay can split completion from durability (the
            # legacy closed-form steps charge it on the client path).  Callers
            # that force persistence elsewhere — RAW's read-after-write — pass
            # persist=False so it is not double-counted.
            n = len(wr.data)
            return WrCost(True, p.xfer_s(n),
                          persist_s=self.dev.write_latency_s(n) if wr.persist
                          else 0.0)
        # two-sided: each RPC is individually polled + serviced by the server
        resp = wr.resp_bytes
        if resp is None:  # measure the response payload when not forced
            resp = (len(h.result) if isinstance(h.result, (bytes, bytearray))
                    else MSG_BYTES)
        return WrCost(False, p.xfer_s(wr.req_bytes),
                      resp_xfer_s=p.xfer_s(resp),
                      cpu_s=p.t_cpu_poll_s
                      + self._service(wr.op, wr.req_bytes, resp))

    def _charge_doorbell(self, handles: List[Handle], qp: int) -> None:
        """One doorbell ring for a posted chain: base RTT / half-RTT legs are
        charged ONCE per chain, marginal transfer / NVM / CPU per WR — all
        through the shared pricing table."""
        wrs = [self._wr_cost(h) for h in handles]
        self.steps.extend(chain_steps(self.p, wrs))
        self.doorbell_trace.append(DoorbellTrace(qp, tuple(wrs)))

    # ------------------------------------------------------------ timing hooks
    def client_crc(self, nbytes: int) -> None:
        self.steps.append(("delay", self.p.crc_s(nbytes)))
        self.doorbell_trace.append(ClientCompute(self.p.crc_s(nbytes)))

    def server_async(self, op: str, nbytes: int) -> None:
        self.steps.append(("cpu_async", self._service(op, nbytes, 0)))
        self.doorbell_trace.append(ServerAsync(self._service(op, nbytes, 0)))


# --------------------------------------------------------------------- replay
def replay_steps(steps: List[Step], cpu: Resource) -> Generator:
    """Turn a captured step trace into a DES op process bound to `cpu`."""
    for kind, s in steps:
        if kind == "delay":
            yield ("delay", s)
        elif kind == "cpu":
            yield ("acquire", cpu, s)
        else:  # cpu_async: background load, no wait
            cpu.request(s, lambda: None)


def steps_latency_s(steps: List[Step]) -> float:
    """Uncontended latency of a step trace (queueing-free lower bound)."""
    return sum(s for kind, s in steps if kind != "cpu_async")


def steps_cpu_s(steps: List[Step]) -> float:
    """Server-CPU seconds a step trace consumes (incl. background work)."""
    return sum(s for kind, s in steps if kind in ("cpu", "cpu_async"))
