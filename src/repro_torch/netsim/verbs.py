"""RDMA verb primitives over the DES, with paper-calibrated constants.

One-sided verbs (read / write / write_with_imm payload leg) consume only
network time — no server CPU — which is the property Erda exploits.  Two-sided
verbs (send/recv) are serviced by the server CPU resource, so they queue when
the CPU saturates; that queueing is what flattens the baselines' throughput
curves in Figs 18-21 of the paper.

All pricing comes from the shared table in ``repro_torch.netsim.pricing``
(``SimParams`` + ``chain_steps``) — the same table ``fabric.sim`` prices
doorbells from — so the calibration (one-sided RTT ≈ 30 µs → Erda read
≈ 62 µs; two-sided read service ≈ 55-60 µs → baseline read ≈ 92 µs) has one
source of truth.  ``SimParams`` is re-exported here for compatibility.
"""
from __future__ import annotations

from typing import Generator

from repro_torch.netsim.pricing import SimParams, WrCost, chain_steps
from repro_torch.netsim.sim import Resource, Simulator

__all__ = ["SimParams", "Verbs"]


class Verbs:
    """Verb generators; compose with ``yield from`` inside op processes."""

    def __init__(self, sim: Simulator, params: SimParams, server_cpu: Resource, nvm=None):
        self.sim = sim
        self.p = params
        self.cpu = server_cpu
        self.nvm = nvm

    def _replay(self, wrs) -> Generator:
        for kind, s in chain_steps(self.p, wrs):
            if kind == "cpu":
                yield ("acquire", self.cpu, s)
            else:
                yield ("delay", s)

    # ---------------------------------------------------------- one-sided
    def one_sided_read(self, nbytes: int) -> Generator:
        yield from self._replay([WrCost(True, self.p.xfer_s(nbytes))])

    def one_sided_write(self, nbytes: int) -> Generator:
        # ACK means "reached NIC cache", NOT persistent — the RDA gap (§1).
        yield from self._replay([WrCost(True, self.p.xfer_s(nbytes))])

    # ---------------------------------------------------------- two-sided
    def send_recv(self, service_s: float, req_bytes: int = 64, resp_bytes: int = 64) -> Generator:
        yield from self._replay([WrCost(False, self.p.xfer_s(req_bytes),
                                        resp_xfer_s=self.p.xfer_s(resp_bytes),
                                        cpu_s=self.p.t_cpu_poll_s + service_s)])

    def cpu_async(self, service_s: float) -> None:
        """Background server work (e.g. applying a redo entry) — consumes CPU
        capacity but does not block the issuing client."""
        self.cpu.request(service_s, lambda: None)

    # ---------------------------------------------------------- NVM latency
    def nvm_write_s(self, nbytes: int) -> float:
        if self.nvm is None:
            return 0.0
        return self.nvm.write_latency_s(nbytes)
