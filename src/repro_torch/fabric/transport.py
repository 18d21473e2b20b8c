"""The pluggable RDMA transport seam (the verb layer of the paper).

The paper's performance argument is entirely about *which verb carries each
byte*: one-sided reads/writes cost only network time, while two-sided sends
queue on the server CPU.  Every remote access the protocol performs therefore
goes through a ``Transport`` exposing the five RDMA primitives Erda uses:

  * ``one_sided_read``     — RDMA READ, no server CPU
  * ``one_sided_write``    — RDMA WRITE, no server CPU (ACK = NIC cache, §1)
  * ``write_with_imm``     — RDMA WRITE WITH IMM: the metadata leg of a write;
                             the server CPU runs a small handler
  * ``send_recv``          — two-sided SEND/RECV RPC, served by the server CPU
  * ``atomic_word_write``  — 8-byte remote atomic store (the paper's
                             atomicity unit, §2.2)

Underneath the five call-and-return verbs sits a **posted-work-request
engine**, the way a real RNIC is driven:

  * ``post(wr, qp=...)``   — enqueue a ``WorkRequest`` on a QP's send queue;
                             returns a ``Handle`` (the WQE's completion cookie)
  * ``flush(qp)``          — ring the doorbell: execute every queued WR of the
                             lane, in posted order, and deliver completions
  * ``poll(qp)``           — drain the completion queue (CQ)
  * ``batch()``            — context manager for doorbell batching: posts
                             accumulate and ONE doorbell per lane is rung at
                             exit; ``batch.fence()`` is an explicit ordering
                             point that rings mid-batch (used where the
                             protocol genuinely orders, e.g. Erda's metadata
                             flip before the dependent data write)
  * ``post_many(wrs)``     — post a list of WRs and ring once

Outside a ``batch()`` every ``post`` rings its own doorbell, so the five
blocking verbs are literally post + flush + poll — one WR, one doorbell — and
all existing callers keep their exact semantics and (in the sim backend)
their exact timing.  WRs on one QP execute in posted order; a WR that raises
drops the rest of its doorbell's chain (RDMA flush-with-error semantics).

Two backends implement the protocol:

  * ``InProcessTransport`` (here) — direct-memory semantics, zero overhead;
    what all functional tests run on.
  * ``SimTransport`` (``repro_torch.fabric.sim``) — same functional semantics, but
    every *doorbell* additionally emits calibrated DES timing steps: the
    per-verb transfer/CPU/persist costs stay per-WR, while the base RTT /
    doorbell overhead is charged once per ring — which is exactly the
    amortization real doorbell batching buys.

Both backends meter per-verb counts (``counts``), a ``doorbells`` counter,
and, when ``trace=True``, record an op-for-op ``OpRecord`` trace — the hook
the verb-count parity tests use to assert the functional model and the timed
model cannot drift: batching changes doorbells, never verbs.

Two-sided ops take the *handler thunk* directly instead of going through a
wire format: the op label (e.g. ``"erda.write_req"``) identifies the RPC for
accounting and for the SimTransport's per-op CPU service-time table, while the
thunk performs the server-side state change in process.
"""
from __future__ import annotations

import dataclasses
from typing import (Any, Callable, Dict, List, Optional, Protocol,
                    runtime_checkable)

from repro_torch.nvmsim.device import NVMDevice

#: the five RDMA primitives of the protocol (order = paper presentation order)
VERBS = ("one_sided_read", "one_sided_write", "write_with_imm", "send_recv",
         "atomic_word_write")

#: the subset that never touches the server CPU
ONE_SIDED_VERBS = ("one_sided_read", "one_sided_write", "atomic_word_write")

#: default wire size of a two-sided request/response descriptor (bytes)
MSG_BYTES = 64


class StaleEpochError(Exception):
    """A posted write carried a replication epoch older than the one this
    QP's memory grant was revoked up to (RDMA permission revocation, cf.
    "The Impact of RDMA on Agreement", 1905.12143): the NIC rejects the WQE
    at ring time, before it touches memory.  The fencing primitive quorum
    failover relies on — a partitioned old primary's in-flight writes can
    never land, let alone be acknowledged, after a promotion."""

    def __init__(self, verb: str, op: str, epoch: int, granted: int):
        super().__init__(
            f"{verb}/{op}: posted with epoch {epoch} but QP grant revoked "
            f"below {granted}")
        self.verb = verb
        self.op = op
        self.epoch = epoch
        self.granted = granted


@dataclasses.dataclass(frozen=True)
class OpRecord:
    """One verb execution: which primitive, which protocol op, how many bytes."""
    verb: str
    op: str
    nbytes: int


@dataclasses.dataclass
class WorkRequest:
    """One posted verb (a WQE).  Which operand fields matter depends on
    ``verb``: one-sided reads use addr/nbytes, writes addr/data/persist,
    atomics addr/word, two-sided ops handler/req_bytes/resp_bytes."""
    verb: str
    op: str = ""
    addr: int = 0
    nbytes: int = 0
    data: Optional[bytes] = None
    word: int = 0
    handler: Optional[Callable[[], Any]] = None
    req_bytes: int = MSG_BYTES
    resp_bytes: Optional[int] = None
    persist: bool = True
    #: replication epoch the WR was posted under (None = unfenced).  Checked
    #: against the transport's granted epoch at ring time — see
    #: ``StaleEpochError``.  Reads never carry an epoch; only write-path WRs
    #: from a replicated group do.
    epoch: Optional[int] = None


class Handle:
    """Completion cookie for a posted WorkRequest."""
    __slots__ = ("wr", "qp", "done", "result")

    def __init__(self, wr: WorkRequest, qp: int):
        self.wr = wr
        self.qp = qp
        self.done = False
        self.result: Any = None

    def __repr__(self):  # pragma: no cover - debugging aid
        state = "done" if self.done else "posted"
        return f"<Handle {self.wr.verb}/{self.wr.op} qp={self.qp} {state}>"


class _Batch:
    """Doorbell-batching scope: posts accumulate; ONE doorbell per lane rings
    at exit.  ``fence()`` rings immediately — the explicit ordering point.

    A batch owns only the WRs posted *through it* (``posted``) and their
    lanes (``lanes``): a fence or exit rings exactly those doorbells, and an
    abort drops exactly those WQEs.  On a transport shared by several
    connections, WQEs another caller posted on its own lane stay posted —
    client A fencing or aborting its batch must never ring client B's
    doorbell nor drop B's (or an enclosing batch's) queued work."""

    def __init__(self, transport: "InProcessTransport"):
        self.t = transport
        self.lanes: set = set()
        self.posted: List[Handle] = []

    def __enter__(self) -> "_Batch":
        self.t._batch_stack.append(self)
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        t = self.t
        if t._batch_stack and t._batch_stack[-1] is self:
            t._batch_stack.pop()
        if exc_type is not None:
            # aborted batch: this batch's posted-but-not-doorbelled WQEs
            # never reach the NIC — drop them instead of letting a later
            # unrelated doorbell execute stale work
            self._abort()
        elif not t._batch_stack:
            self._ring_own()
        else:
            # nested batch merges into its parent: the outer scope's single
            # doorbell covers these lanes
            parent = t._batch_stack[-1]
            parent.lanes |= self.lanes
            parent.posted += self.posted
            self.lanes, self.posted = set(), []
        return False

    def fence(self) -> None:
        """Ring now: everything posted so far completes before anything
        posted after — used where the protocol genuinely orders (e.g. the
        metadata flip a dependent data write needs the address from).
        Rings ONLY this batch's lanes."""
        self._ring_own()

    def _ring_own(self) -> None:
        """Ring the doorbell of every lane posted within this batch.  A chain
        that faults drops THIS batch's remaining posted WQEs (flush-with-error
        scoped to the batch) and propagates."""
        lanes, self.lanes = sorted(self.lanes), set()
        posted, self.posted = self.posted, []
        try:
            for lane in lanes:
                self.t._ring(lane)
        except BaseException:
            self._drop(posted)
            raise

    def _abort(self) -> None:
        """Discard this batch's queued-but-unrung WRs — and only this
        batch's: an enclosing batch's WQEs sharing a lane stay posted."""
        posted, self.posted = self.posted, []
        self._drop(posted)
        self.lanes = set()

    def _drop(self, posted: List[Handle]) -> None:
        for h in posted:
            q = self.t._sq.get(h.qp)
            if q and h in q:
                q.remove(h)


@runtime_checkable
class Transport(Protocol):
    """The posted-verb seam every store issues its remote access through."""

    def post(self, wr: WorkRequest, qp: int = 0) -> Handle: ...

    def poll(self, qp: int = 0, max_n: Optional[int] = None) -> List[Handle]: ...

    def batch(self) -> _Batch: ...

    def one_sided_read(self, addr: int, nbytes: int, *, op: str = "",
                       qp: int = 0) -> bytes: ...

    def one_sided_write(self, addr: int, data: bytes, *, op: str = "",
                        persist: bool = True, qp: int = 0,
                        epoch: Optional[int] = None) -> None: ...

    def write_with_imm(self, op: str, handler: Callable[[], Any], *,
                       req_bytes: int = MSG_BYTES, qp: int = 0,
                       epoch: Optional[int] = None) -> Any: ...

    def send_recv(self, op: str, handler: Callable[[], Any], *,
                  req_bytes: int = MSG_BYTES,
                  resp_bytes: Optional[int] = None, qp: int = 0,
                  epoch: Optional[int] = None) -> Any: ...

    def atomic_word_write(self, addr: int, word: int, *, op: str = "",
                          qp: int = 0, epoch: Optional[int] = None) -> None: ...


class InProcessTransport:
    """Direct-memory transport: the functional-model backend.

    Executes every primitive against the target NVM device / server handler
    with zero overhead, while metering verb counts, doorbells, and optionally
    a full op trace so tests can assert the protocol's verb footprint.
    """

    def __init__(self, dev: NVMDevice, *, trace: bool = False):
        self.dev = dev
        self.counts: Dict[str, int] = {v: 0 for v in VERBS}
        self.doorbells = 0
        #: lowest replication epoch this endpoint still accepts writes under.
        #: ``revoke_epochs_below(e)`` models a new primary revoking the old
        #: primary's RDMA write grant at promotion.
        self.granted_epoch = 0
        self.stale_rejected = 0
        self.trace_enabled = trace
        self.trace: List[OpRecord] = []
        self._sq: Dict[int, List[Handle]] = {}  # per-QP send queues (posted)
        self._cq: Dict[int, List[Handle]] = {}  # per-QP completion queues
        self._batch_stack: List[_Batch] = []  # innermost batch owns new posts

    # ------------------------------------------------------------- bookkeeping
    def _note(self, verb: str, op: str, nbytes: int) -> None:
        self.counts[verb] += 1
        if self.trace_enabled:
            self.trace.append(OpRecord(verb, op, nbytes))

    def take_trace(self) -> List[OpRecord]:
        t, self.trace = self.trace, []
        return t

    # -------------------------------------------------------- epoch fencing
    def revoke_epochs_below(self, epoch: int) -> None:
        """Revoke the write grant of every epoch below ``epoch`` on this
        endpoint (promotion installs this at each surviving replica).  A WQE
        posted under an older epoch is rejected at ring time with
        ``StaleEpochError`` — the one-sided-permission fence of 1905.12143.
        Monotonic: a grant, once revoked, cannot be re-extended."""
        self.granted_epoch = max(self.granted_epoch, epoch)

    # ----------------------------------------------------------- posted engine
    def post(self, wr: WorkRequest, qp: int = 0) -> Handle:
        """Post a WR on lane ``qp``.  Outside a batch() scope the doorbell
        rings immediately (one WR, one doorbell — the classic blocking verb)."""
        h = Handle(wr, qp)
        self._sq.setdefault(qp, []).append(h)
        if not self._batch_stack:
            self._ring(qp)
        else:
            # the innermost open batch owns this WR: its fence/exit (and
            # nothing else) rings the doorbell; its abort drops it
            self._batch_stack[-1].lanes.add(qp)
            self._batch_stack[-1].posted.append(h)
        return h

    def post_many(self, wrs: List[WorkRequest], qp: int = 0) -> List[Handle]:
        """Post a chain of WRs and ring ONE doorbell for all of them."""
        with self.batch():
            return [self.post(wr, qp) for wr in wrs]

    def batch(self) -> _Batch:
        return _Batch(self)

    def flush(self, qp: Optional[int] = None) -> None:
        """Ring the doorbell: execute queued WRs (all lanes if qp is None)."""
        if qp is not None:
            self._ring(qp)
            return
        try:
            for lane in sorted(self._sq):
                self._ring(lane)
        except BaseException:
            # flush-with-error across lanes: a chain that faults must not
            # leave the remaining lanes' posted-but-unrung WQEs behind to
            # fire on a later unrelated doorbell
            self._abort_posted()
            raise

    def _abort_posted(self) -> None:
        """Discard every queued-but-unrung WR (an aborted batch)."""
        for lane in self._sq:
            self._sq[lane] = []

    def poll(self, qp: int = 0, max_n: Optional[int] = None) -> List[Handle]:
        """Drain (up to ``max_n``) completions from lane ``qp``'s CQ."""
        cq = self._cq.get(qp)
        if not cq:
            return []
        if max_n is None:
            out, self._cq[qp] = cq, []
        else:
            out, self._cq[qp] = cq[:max_n], cq[max_n:]
        return out

    def _ring(self, qp: int) -> None:
        """Execute the lane's posted chain in order; deliver completions and
        charge the backend's per-doorbell cost.  A WR that raises drops the
        rest of the chain (flush-with-error) and propagates."""
        pending = self._sq.get(qp)
        if not pending:
            return
        self._sq[qp] = []
        self.doorbells += 1
        executed: List[Handle] = []
        try:
            for h in pending:
                h.result = self._execute(h.wr)
                h.done = True
                executed.append(h)
        finally:
            if executed:
                self._cq.setdefault(qp, []).extend(executed)
                self._charge_doorbell(executed, qp)

    def _execute(self, wr: WorkRequest) -> Any:
        """Direct-memory execution of one WR (the functional semantics)."""
        verb = wr.verb
        if wr.epoch is not None and wr.epoch < self.granted_epoch:
            # permission check happens BEFORE the WR touches memory or the
            # verb census: the NIC bounces the WQE, flush-with-error drops
            # the rest of its chain
            self.stale_rejected += 1
            raise StaleEpochError(verb, wr.op, wr.epoch, self.granted_epoch)
        if verb == "one_sided_read":
            self._note(verb, wr.op, wr.nbytes)
            return self.dev.read(wr.addr, wr.nbytes).tobytes()
        if verb == "one_sided_write":
            self._note(verb, wr.op, len(wr.data))
            self.dev.write(wr.addr, wr.data)  # may raise TornWrite under fault
            return None
        if verb == "atomic_word_write":
            self._note(verb, wr.op, 8)
            self.dev.write_u64_atomic(wr.addr, wr.word)
            return None
        if verb in ("write_with_imm", "send_recv"):
            self._note(verb, wr.op, wr.req_bytes)
            return wr.handler()
        raise ValueError(f"unknown verb {verb!r}")

    def _charge_doorbell(self, handles: List[Handle], qp: int) -> None:
        """Backend hook, called once per doorbell with the executed chain.
        Zero cost here; SimTransport prices the batch."""

    def _call(self, wr: WorkRequest, qp: int = 0) -> Any:
        """Blocking verb = post + flush + consume own completion.  Called
        inside an open batch() it acts as a fence for its lane."""
        h = self.post(wr, qp)
        if not h.done:
            self._ring(qp)
        cq = self._cq.get(qp)
        if cq and cq[-1] is h:  # consume our completion so the CQ stays clean
            cq.pop()
        elif cq and h in cq:
            cq.remove(h)
        return h.result

    # --------------------------------------------------------------- one-sided
    def one_sided_read(self, addr: int, nbytes: int, *, op: str = "",
                       qp: int = 0) -> bytes:
        return self._call(WorkRequest("one_sided_read", op=op, addr=addr,
                                      nbytes=nbytes), qp)

    def one_sided_write(self, addr: int, data: bytes, *, op: str = "",
                        persist: bool = True, qp: int = 0,
                        epoch: Optional[int] = None) -> None:
        """``persist=False`` when the scheme pays for persistence elsewhere
        (e.g. RAW's forcing read) — only the sim backend's latency model cares."""
        self._call(WorkRequest("one_sided_write", op=op, addr=addr, data=data,
                               persist=persist, epoch=epoch), qp)

    def atomic_word_write(self, addr: int, word: int, *, op: str = "",
                          qp: int = 0, epoch: Optional[int] = None) -> None:
        self._call(WorkRequest("atomic_word_write", op=op, addr=addr,
                               word=word, epoch=epoch), qp)

    # --------------------------------------------------------------- two-sided
    def write_with_imm(self, op: str, handler: Callable[[], Any], *,
                       req_bytes: int = MSG_BYTES, qp: int = 0,
                       epoch: Optional[int] = None) -> Any:
        return self._call(WorkRequest("write_with_imm", op=op, handler=handler,
                                      req_bytes=req_bytes, epoch=epoch), qp)

    def send_recv(self, op: str, handler: Callable[[], Any], *,
                  req_bytes: int = MSG_BYTES,
                  resp_bytes: Optional[int] = None, qp: int = 0,
                  epoch: Optional[int] = None) -> Any:
        return self._call(WorkRequest("send_recv", op=op, handler=handler,
                                      req_bytes=req_bytes,
                                      resp_bytes=resp_bytes, epoch=epoch), qp)

    # ------------------------------------------------- non-verb timing hooks
    # These carry no bytes over the fabric; the sim backend turns them into
    # client-compute delays / background server-CPU load.
    def client_crc(self, nbytes: int) -> None:
        pass

    def server_async(self, op: str, nbytes: int) -> None:
        pass


def make_transport(kind: str, dev: NVMDevice, **kwargs):
    """Transport factory: ``"inproc"`` or ``"sim"``."""
    if kind == "inproc":
        return InProcessTransport(dev, **kwargs)
    if kind == "sim":
        from repro_torch.fabric.sim import SimTransport
        return SimTransport(dev, **kwargs)
    raise ValueError(f"unknown transport kind {kind!r}")
