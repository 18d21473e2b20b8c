"""A compact discrete-event simulator for the RDMA fabric + server CPU.

The paper evaluates Erda on a 2-node InfiniBand cluster; this container has no
NIC, so (mirroring the paper's own choice to *simulate NVM*) we simulate the
fabric with an event-driven model and calibrate its constants against the
paper's measured latencies (§5.2).  The simulator is deliberately small:

  * ``Simulator`` — a heapq event loop with virtual time in seconds.
  * ``Resource``  — an m-worker FIFO resource (the server's CPU cores, the
    per-NIC link, the NVM persistence engine); it meters busy-seconds so the
    paper's "normalized CPU cost" (Figs 22-25) can be computed.
  * ``FifoLock``  — an explicitly held FIFO mutex (a QP send queue): a chain
    holds it across a span of steps, later chains queue behind it in posted
    order — the head-of-line blocking the contention model measures.
  * ``run_process`` — drives generator-based processes that yield
    ``("delay", seconds)``, ``("acquire", resource, service_seconds)``,
    ``("lock", fifo_lock)`` or ``("unlock", fifo_lock)`` steps.

Determinism: the event heap breaks time ties by insertion sequence number and
every stochastic input is drawn from seeded numpy generators before/while the
loop runs, so a fixed seed + config reproduces the event trace byte for byte.

Client threads are either closed-loop (issue, wait, repeat, as YCSB does) or
open-loop (Poisson arrivals at an offered rate — ``repro_torch.serving.load``).
"""
from __future__ import annotations

import heapq
import math
from collections import deque
from typing import Callable, Deque, Generator, List, Optional, Tuple

Step = Tuple  # ("delay", s) | ("acquire", Resource, s)


class Simulator:
    def __init__(self):
        self.now = 0.0
        self._q: List[Tuple[float, int, Callable[[], None]]] = []
        self._seq = 0

    def at(self, t: float, fn: Callable[[], None]) -> None:
        if t < self.now:
            raise ValueError(f"scheduling in the past: {t} < {self.now}")
        heapq.heappush(self._q, (t, self._seq, fn))
        self._seq += 1

    def after(self, delay: float, fn: Callable[[], None]) -> None:
        self.at(self.now + delay, fn)

    def run(self, until: float = math.inf) -> None:
        while self._q and self._q[0][0] <= until:
            t, _, fn = heapq.heappop(self._q)
            self.now = t
            fn()
        if until is not math.inf:
            self.now = max(self.now, until)


class Resource:
    """FIFO multi-worker resource with busy-time metering (the server CPU)."""

    def __init__(self, sim: Simulator, workers: int, name: str = "cpu"):
        self.sim = sim
        self.workers = workers
        self.name = name
        self._free = workers
        # deque: the FIFO is popped from the front on every service completion,
        # which is the hot path of a saturated-CPU run (list.pop(0) is O(n))
        self._queue: Deque[Tuple[float, Callable[[], None]]] = deque()
        self.busy_seconds = 0.0
        self.completed = 0

    def request(self, service_s: float, done: Callable[[], None]) -> None:
        if self._free > 0:
            self._free -= 1
            self._start(service_s, done)
        else:
            self._queue.append((service_s, done))

    def _start(self, service_s: float, done: Callable[[], None]) -> None:
        self.busy_seconds += service_s

        def _finish():
            self.completed += 1
            done()
            if self._queue:
                s, d = self._queue.popleft()
                self._start(s, d)
            else:
                self._free += 1

        self.sim.after(service_s, _finish)

    def utilization(self, horizon_s: float) -> float:
        if horizon_s <= 0:
            return 0.0
        return self.busy_seconds / (horizon_s * self.workers)


class FifoLock:
    """An explicitly held FIFO mutex — the DES model of a QP send queue.

    Unlike ``Resource`` (which holds a worker for a fixed service time), a
    FifoLock is held across an arbitrary span of a process's steps via
    ``("lock", qp)`` … ``("unlock", qp)``, so a doorbell chain can occupy its
    QP for its whole NIC-issue phase.  Waiters are granted strictly in arrival
    order: a long chain at the head of the queue delays every later chain on
    the same QP — head-of-line blocking, which the stats meter:

      * ``max_queue_depth`` — deepest the send queue ever got,
      * ``wait_events`` / ``wait_seconds`` — how many chains queued and for
        how long (the HoL-blocking cost),
      * ``acquisitions`` — total chains issued through this QP.
    """

    def __init__(self, sim: Simulator, name: str = "qp"):
        self.sim = sim
        self.name = name
        self._held = False
        self._waiters: Deque[Tuple[float, Callable[[], None]]] = deque()
        self.acquisitions = 0
        self.wait_events = 0
        self.wait_seconds = 0.0
        self.max_queue_depth = 0

    @property
    def queue_depth(self) -> int:
        return len(self._waiters)

    def acquire(self, fn: Callable[[], None]) -> None:
        if not self._held:
            self._held = True
            self.acquisitions += 1
            fn()
        else:
            self._waiters.append((self.sim.now, fn))
            self.wait_events += 1
            self.max_queue_depth = max(self.max_queue_depth, len(self._waiters))

    def release(self) -> None:
        if not self._held:  # pragma: no cover - programming error
            raise RuntimeError(f"release of unheld lock {self.name!r}")
        if self._waiters:
            t0, fn = self._waiters.popleft()
            self.wait_seconds += self.sim.now - t0
            self.acquisitions += 1
            fn()  # lock stays held, ownership transfers FIFO
        else:
            self._held = False

    def stats(self) -> dict:
        return {"name": self.name, "acquisitions": self.acquisitions,
                "wait_events": self.wait_events,
                "wait_seconds": round(self.wait_seconds, 9),
                "max_queue_depth": self.max_queue_depth}


def run_process(sim: Simulator, gen: Generator, done: Optional[Callable[[], None]] = None) -> None:
    """Drive a generator process; see module docstring for the step protocol."""

    def _advance(_=None):
        try:
            step = next(gen)
        except StopIteration:
            if done is not None:
                done()
            return
        kind = step[0]
        if kind == "delay":
            sim.after(step[1], _advance)
        elif kind == "acquire":
            step[1].request(step[2], _advance)
        elif kind == "lock":
            step[1].acquire(_advance)
        elif kind == "unlock":
            step[1].release()
            _advance()
        else:  # pragma: no cover - programming error
            raise ValueError(f"unknown step {step!r}")

    _advance()


class ClosedLoopClient:
    """A YCSB-style closed-loop client thread: issue op, wait, record, repeat.

    ``op_factory`` may return either a bare op generator or a
    ``(kind, generator)`` pair — kinds land in ``records`` so run reports can
    break latency percentiles down per op type (read vs update)."""

    def __init__(self, sim: Simulator, op_factory: Callable[[], Generator], horizon_s: float):
        self.sim = sim
        self.op_factory = op_factory
        self.horizon_s = horizon_s
        self.latencies: List[float] = []
        self.records: List[Tuple[str, float]] = []  # (op kind, latency seconds)
        self.completed = 0

    def start(self) -> None:
        self._issue()

    def _issue(self) -> None:
        if self.sim.now >= self.horizon_s:
            return
        t0 = self.sim.now
        op = self.op_factory()
        kind, gen = op if isinstance(op, tuple) else ("op", op)

        def _done():
            self.latencies.append(self.sim.now - t0)
            self.records.append((kind, self.sim.now - t0))
            self.completed += 1
            self._issue()

        run_process(self.sim, gen, _done)
