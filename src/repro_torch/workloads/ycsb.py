"""YCSB workload generation (§5.1 of the paper).

Four workloads over a Zipfian(0.99) key popularity distribution:
  YCSB-C 100% read · YCSB-B 95/5 · YCSB-A 50/50 · update-only 100% write.

The Zipfian generator is the standard YCSB one (Gray et al., "Quickly
generating billion-record synthetic databases"), vectorized with numpy.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np


class ZipfianGenerator:
    def __init__(self, n_items: int, theta: float = 0.99, seed: int = 0):
        self.n = int(n_items)
        self.theta = theta
        ranks = np.arange(1, self.n + 1, dtype=np.float64)
        self.zetan = float(np.sum(1.0 / ranks**theta))
        self.zeta2 = float(np.sum(1.0 / np.arange(1, 3, dtype=np.float64) ** theta))
        self.alpha = 1.0 / (1.0 - theta)
        self.eta = (1.0 - (2.0 / self.n) ** (1.0 - theta)) / (1.0 - self.zeta2 / self.zetan)
        self.rng = np.random.default_rng(seed)

    def sample(self, size: int) -> np.ndarray:
        u = self.rng.random(size)
        uz = u * self.zetan
        out = np.floor(self.n * (self.eta * u - self.eta + 1.0) ** self.alpha).astype(np.int64)
        out = np.where(uz < 1.0, 0, out)
        out = np.where((uz >= 1.0) & (uz < 1.0 + 0.5**self.theta), 1, out)
        return np.clip(out, 0, self.n - 1)


@dataclasses.dataclass(frozen=True)
class Workload:
    name: str
    read_fraction: float

    def ops(self, n_ops: int, n_keys: int, seed: int = 0) -> List[Tuple[str, int]]:
        """Returns a list of ("read"|"update", key_index) ops."""
        zipf = ZipfianGenerator(n_keys, seed=seed)
        keys = zipf.sample(n_ops)
        # scramble popularity ranks over the key space deterministically (YCSB
        # hashes ranks so hot keys are spread out)
        scramble = np.random.default_rng(12345).permutation(n_keys)
        keys = scramble[keys]
        is_read = np.random.default_rng(seed + 1).random(n_ops) < self.read_fraction
        return [("read" if r else "update", int(k)) for r, k in zip(is_read, keys)]


WORKLOADS = {
    "ycsb_c": Workload("ycsb_c", 1.00),
    "ycsb_b": Workload("ycsb_b", 0.95),
    "ycsb_a": Workload("ycsb_a", 0.50),
    "update_only": Workload("update_only", 0.00),
}


def make_ops(workload: str, n_ops: int, n_keys: int, seed: int = 0):
    return WORKLOADS[workload].ops(n_ops, n_keys, seed)


# --------------------------------------------------------------- store driver
def _sim_lanes(store) -> List[Tuple[int, object]]:
    """``[(host port index, transport)]`` for a SimTransport-backed store.

    A cluster store exposes one lane per replica, mapped to the port of the
    host that physically holds it (shard i's backup j lives on host
    ``replica_hosts[j]``); a single-server store is one lane on port 0.
    Raises for stores whose transports cannot capture doorbells (the
    contended replay needs ``take_doorbells``)."""
    cluster = getattr(store, "cluster", None)
    if cluster is not None:
        # shard ids need not be contiguous after elastic membership changes:
        # ports are indexed by position in the sorted id list, and a mirror
        # host's id goes through the same mapping
        ids = sorted(cluster.groups.keys())
        pos = {sid: i for i, sid in enumerate(ids)}
        lanes = []
        for sid in ids:
            g = cluster.groups[sid]
            for j, c in enumerate(g.replicas):
                lanes.append((pos[sid] if j == 0 else pos[g.replica_hosts[j]],
                              c.transport))
    else:
        t = getattr(store, "transport", None)
        if t is None:
            t = getattr(getattr(store, "client", None), "transport", None)
        lanes = [(0, t)] if t is not None else []
    if not lanes or not all(hasattr(t, "take_doorbells") for _, t in lanes):
        raise TypeError(
            "contended_threads needs a SimTransport-backed store (the "
            "contended replay works from captured doorbell traces)")
    return lanes


def _replay_contended(units: List[Tuple[str, int, list]], n_threads: int,
                      p=None) -> dict:
    """Replay captured per-op doorbell units as ``n_threads`` CLOSED-LOOP
    client threads over the contended fabric: shared per-host ``ServerPort``
    resources, one ``FifoLock`` QP per (thread, host).

    Units are dealt round-robin to threads in stream order; each thread
    issues its next unit only when the previous one's lanes all completed —
    the closed loop.  Unlike the uncontended functional pass (which scales
    linearly by construction), this shows honest saturation: throughput
    flattens once the shared NICs/CPUs are busy."""
    from repro_torch.netsim.contention import (ServerPort, qp_stats_summary,
                                         replay_doorbells)
    from repro_torch.netsim.pricing import SimParams
    from repro_torch.netsim.sim import FifoLock, Simulator, run_process
    from repro_torch.workloads.metrics import LatencyRecorder

    p = p or SimParams()
    sim = Simulator()
    n_ports = 1 + max(port for _, _, lanes in units for port, _ in lanes)
    ports = [ServerPort(sim, p, f"srv{j}") for j in range(n_ports)]
    recorder = LatencyRecorder()
    end_t = [0.0]
    qps_all = {}

    def start_thread(t: int) -> None:
        mine = units[t::n_threads]
        qps = {j: FifoLock(sim, f"t{t}.qp{j}") for j in range(n_ports)}
        qps_all.update({qp.name: qp for qp in qps.values()})

        def issue(i: int) -> None:
            if i == len(mine):
                return
            kind, n_ops, lanes = mine[i]
            t0 = sim.now
            remaining = [len(lanes)]

            def lane_done():
                remaining[0] -= 1
                if remaining[0] == 0:
                    recorder.record(kind, (sim.now - t0) / max(n_ops, 1))
                    end_t[0] = max(end_t[0], sim.now)
                    issue(i + 1)

            for port_idx, tr in lanes:
                run_process(sim, replay_doorbells(tr, qps[port_idx],
                                                  ports[port_idx]), lane_done)

        issue(0)

    for t in range(n_threads):
        start_thread(t)
    sim.run()
    elapsed = end_t[0]
    total_ops = sum(n for _, n, _ in units)
    return {"n_threads": n_threads, "units": len(units),
            "ops_replayed": total_ops,
            "elapsed_s": round(elapsed, 9),
            "throughput_kops": round(total_ops / elapsed / 1e3, 2)
            if elapsed else 0.0,
            "latency": recorder.summary(),
            "qp": qp_stats_summary(qps_all),
            "ports": [port.stats(elapsed or 1.0) for port in ports]}


def _op_runs(ops, batch_size: int):
    """Split an op stream into maximal same-kind runs of ≤ batch_size — the
    unit a batched client can issue as one multi-op without reordering a
    read past a write it depends on."""
    run, kind = [], None
    for op, k in ops:
        if op != kind or len(run) == batch_size:
            if run:
                yield kind, run
            run, kind = [], op
        run.append(k)
    if run:
        yield kind, run


def run_store_workload(store, workload: str, n_ops: int, n_keys: int,
                       value_size: int = 128, seed: int = 0,
                       batch_size: int = 0, contended_threads: int = 0,
                       p=None) -> dict:
    """Drive any ``make_store(...)`` object (single-server Erda, sharded
    ``erda-cluster``, or a baseline) with a YCSB op stream, checking every
    read against a dict model.  Returns op counts + the store's own stats —
    the functional-side companion of the DES benchmarks.

    ``batch_size > 1`` enables batched mode: same-kind op runs (up to
    batch_size) go through the store's doorbell-batched ``multi_read`` /
    ``multi_write`` instead of one call per op.

    ``contended_threads > 0`` retrofits the closed loop onto the contended
    fabric: the functional pass (which still checks every read) doubles as
    trace capture — each issued unit's doorbell lanes are recorded off the
    store's ``SimTransport``s — and the captured units are then replayed as
    that many closed-loop threads over shared ``ServerPort`` resources with
    per-thread ``FifoLock`` QPs.  The result gains a ``"contended"`` section
    (throughput, latency percentiles, QP/port stats) whose
    throughput-vs-threads curve saturates honestly instead of scaling
    linearly the way the uncontended functional timing would."""
    ops = make_ops(workload, n_ops, n_keys, seed)
    rng = np.random.default_rng(seed + 2)
    model = {}
    batched = batch_size and batch_size > 1
    capture_lanes = _sim_lanes(store) if contended_threads else []
    units: List[Tuple[str, int, list]] = []

    def _drain():
        for _, t in capture_lanes:
            t.take_doorbells()
            t.take_steps()

    def _capture(kind: str, n: int) -> None:
        unit = [(port, tr) for port, t in capture_lanes
                if (tr := t.take_doorbells())]
        if unit:
            units.append((kind, n, unit))
    # load phase: every key gets an initial value (YCSB's load stage);
    # keys are 1-based: 0 is the empty-slot sentinel
    load = [(k + 1, rng.bytes(value_size)) for k in range(n_keys)]
    if batched:
        for i in range(0, len(load), batch_size):
            store.multi_write(load[i : i + batch_size])
    else:
        for k, v in load:
            store.write(k, v)
    model.update(load)
    if contended_threads:
        _drain()  # the load phase's doorbells are not part of the run
    n_reads = n_writes = 0
    if batched:
        for kind, keys in _op_runs(ops, batch_size):
            keys = [k + 1 for k in keys]
            if kind == "read":
                n_reads += len(keys)
                got = store.multi_read(keys)
                for k, g in zip(keys, got):
                    if g != model.get(k):  # must check even under -O
                        raise RuntimeError(f"driver mismatch on key {k}")
            else:
                n_writes += len(keys)
                items = [(k, rng.bytes(value_size)) for k in keys]
                store.multi_write(items)
                model.update(items)
            if contended_threads:
                _capture(kind, len(keys))
    else:
        for op, k in ops:
            k += 1
            if op == "read":
                n_reads += 1
                got = store.read(k)
                if got != model.get(k):  # must check even under -O
                    raise RuntimeError(f"driver mismatch on key {k}")
            else:
                n_writes += 1
                v = rng.bytes(value_size)
                store.write(k, v)
                model[k] = v
            if contended_threads:
                _capture("read" if op == "read" else "update", 1)
    stats = dict(store.stats)
    result = {"workload": workload, "n_ops": len(ops), "n_keys": n_keys,
            "reads": n_reads, "writes": n_writes, "batch_size": batch_size,
            # location-cache effectiveness, surfaced top-level for reports
            # (baseline stores have no speculation → zeros)
            "spec_hits": stats.get("spec_hits", 0),
            "spec_misses": stats.get("spec_misses", 0),
            "spec_invalidations": stats.get("spec_invalidations", 0),
            "store_stats": stats}
    if contended_threads:
        result["contended"] = _replay_contended(units, contended_threads, p)
        _drain()  # leave no stale captures behind for the caller
    return result


# ----------------------------------------------------- kill-a-shard scenario
def run_failover_workload(store, workload: str, n_ops: int, n_keys: int,
                          value_size: int = 128, seed: int = 0,
                          kill_at: Optional[int] = None,
                          shard: Optional[int] = None) -> dict:
    """Drive a REPLICATED cluster store (``replication=2``) with a YCSB op
    stream and kill a shard's primary replica mid-stream.

    At op index ``kill_at`` (default: halfway) the current op's owning shard
    — or ``shard`` if given — loses its primary (``fail_shard``).  Reads on
    the degraded shard keep serving through quorum reads across the backups;
    writes raise ``ShardDownError`` and the driver reacts the way a real
    client library would: run ``failover`` (promote the backup) once, then
    retry the op against the promoted replica.  Every read is checked
    against the dict model of ACKNOWLEDGED writes — a write that raised is
    not in the model — so the run proves zero lost acknowledged writes and
    zero stale reads through the degraded window and the promotion."""
    from repro_torch.core import ShardDownError

    ops = make_ops(workload, n_ops, n_keys, seed)
    rng = np.random.default_rng(seed + 2)
    model = {}
    for k in range(n_keys):  # load phase (keys 1-based; 0 is the empty slot)
        v = rng.bytes(value_size)
        store.write(k + 1, v)
        model[k + 1] = v
    kill_at = n_ops // 2 if kill_at is None else kill_at
    failovers = denied = n_reads = n_writes = 0
    killed_shard = None
    for i, (op, k) in enumerate(ops):
        k += 1
        if i == kill_at:
            killed_shard = store.shard_for_key(k) if shard is None else shard
            store.fail_shard(killed_shard)
        for attempt in (0, 1):
            try:
                if op == "read":
                    got = store.read(k)
                    if got != model.get(k):  # must check even under -O
                        raise RuntimeError(f"lost acknowledged write, key {k}")
                else:
                    v = rng.bytes(value_size)
                    store.write(k, v)
                    model[k] = v  # acknowledged only when write returned
                break
            except ShardDownError as e:
                denied += 1
                if attempt:  # failover already ran — a second denial is a bug
                    raise
                store.failover(e.shard)
                failovers += 1
        if op == "read":
            n_reads += 1
        else:
            n_writes += 1
    # quorum reads can mask a down primary for the whole remaining stream
    # (a read-heavy workload may never hit it with a write): restore full
    # service before the sweep, like an operator would
    for sh in getattr(store, "shard_ids", range(store.n_shards)):
        if store.group(sh).primary_down:
            store.failover(sh)
            failovers += 1
    # final sweep: every acknowledged write survives the failover.  With an
    # explicit ``shard`` (or a kill near the stream's end) no in-stream op may
    # have hit the dead shard, so the sweep applies the same failover-once
    # reaction the op loop does.
    for k, v in model.items():
        try:
            got = store.read(k)
        except ShardDownError as e:
            denied += 1
            store.failover(e.shard)
            failovers += 1
            got = store.read(k)
        if got != v:
            raise RuntimeError(f"post-failover mismatch on key {k}")
    stats = dict(store.stats)
    cluster = store.cluster
    return {"workload": workload, "n_ops": len(ops), "reads": n_reads,
            "writes": n_writes, "killed_shard": killed_shard,
            "failovers": failovers, "denied_ops": denied,
            # quorum/fencing visibility: how often the degraded path served,
            # how many promotions bumped epochs, how many stale-epoch writes
            # the QPs bounced
            "epoch_bumps": cluster.epoch_bumps,
            "degraded_reads": cluster.degraded_reads,
            "stale_rejected": cluster.stale_rejected,
            "spec_hits": stats.get("spec_hits", 0),
            "spec_misses": stats.get("spec_misses", 0),
            "spec_invalidations": stats.get("spec_invalidations", 0),
            "store_stats": stats}


# ------------------------------------------------- kill/heal/partition chaos
def run_chaos_workload(store, workload: str = "ycsb_a", n_ops: int = 400,
                       n_keys: int = 60, value_size: int = 64, seed: int = 0,
                       plan=None, n_faults: int = 6) -> dict:
    """THE quorum acceptance scenario: drive a ``replication>=3`` cluster
    store with a YCSB op stream while a seeded ``FaultPlan`` repeatedly
    kills replicas (primaries AND backups), partitions primaries mid-write,
    and heals — proving zero lost acked writes and zero stale reads through
    every promotion.

    Event semantics:
      * kill_primary / kill_backup — the replica's NVM is wiped
        (``fail_shard(wipe=True)``); reads on a primary-less group keep
        serving through quorum reads, and the first denied WRITE triggers
        the epoch-fenced ``failover``.
      * partition — the nastiest window: a mirrored write is cut off after
        its metadata flips but before its data-leg doorbells ring
        (``ShardGroup.begin_partitioned_write``); a backup is promoted under
        a bumped epoch, then the old coordinator's in-flight WQEs ring and
        the driver asserts every surviving QP REJECTED them (the write is
        un-acked, so the model keeps the old value) before retrying the
        write through the new primary.
      * heal — ``recover_shard``: crash-restart intact members, resync
        fresh replicas into wiped/evicted slots (promoting first if the
        primary is still down).

    Reads are dict-model-checked op by op — a stale read raises — and a
    final sweep re-verifies every acked write after all shards heal.  The
    returned report carries the plan counters plus the cluster's epoch /
    degraded-read / stale-rejection telemetry (the CI criterion reads
    ``lost_acked_writes``/``stale_reads`` off it)."""
    from repro_torch.core import ShardDownError
    from repro_torch.workloads.faults import FaultPlan

    cluster = store.cluster
    if plan is None:
        plan = FaultPlan.generate(seed=seed, n_ops=n_ops,
                                  n_shards=store.n_shards,
                                  replication=cluster.replication,
                                  n_faults=n_faults)
    ops = make_ops(workload, n_ops, n_keys, seed)
    rng = np.random.default_rng(seed + 2)
    model = {}
    for k in range(n_keys):  # load phase (keys 1-based; 0 is the empty slot)
        v = rng.bytes(value_size)
        store.write(k + 1, v)
        model[k + 1] = v
    # one probe key per shard for partition events' in-flight writes
    probe_key: dict = {}
    k = n_keys + 1
    while len(probe_key) < store.n_shards:
        probe_key.setdefault(store.shard_for_key(k), k)
        k += 1
    counters = {"kills": 0, "heals": 0, "partitions": 0, "failovers": 0,
                "denied_ops": 0, "splitbrain_rejections": 0}

    def _heal(shard: int) -> None:
        g = store.group(shard)
        if g.primary_down:  # a wiped primary can only be promoted away
            store.failover(shard)
            counters["failovers"] += 1
        store.recover_shard(shard)
        counters["heals"] += 1

    def _apply(ev) -> None:
        g = store.group(ev.shard)
        if ev.kind == "heal":
            _heal(ev.shard)
        elif ev.kind == "kill_primary":
            store.fail_shard(ev.shard, 0, wipe=True)
            counters["kills"] += 1
        elif ev.kind == "kill_backup":
            idx = min(ev.replica, len(g.replicas) - 1)
            if idx >= 1 and not g.down[idx]:
                store.fail_shard(ev.shard, idx, wipe=True)
                counters["kills"] += 1
        elif ev.kind == "partition":
            if g.primary_down or g.live_count < g.write_quorum:
                return  # can't start a write to cut off
            key, val = probe_key[ev.shard], rng.bytes(value_size)
            w = g.begin_partitioned_write(key, val)
            g.fail_replica(0)  # the partition cuts the coordinator off
            store.failover(ev.shard)
            counters["failovers"] += 1
            counters["partitions"] += 1
            outcomes = w.ring()  # the stale-epoch WQEs finally reach the NICs
            counters["splitbrain_rejections"] += outcomes.count("rejected")
            if w.acked:
                raise RuntimeError(
                    f"split-brain: partitioned write on shard {ev.shard} "
                    f"reached a write quorum ({outcomes})")
            # un-acked → not in the model; retry through the new primary and
            # only then acknowledge
            store.write(key, val)
            model[key] = val

    n_reads = n_writes = 0
    for i, (op, key) in enumerate(ops):
        for ev in plan.due(i):
            _apply(ev)
        key += 1
        for attempt in (0, 1):
            try:
                if op == "read":
                    got = store.read(key)
                    if got != model.get(key):  # must check even under -O
                        raise RuntimeError(f"stale read on key {key}")
                else:
                    v = rng.bytes(value_size)
                    store.write(key, v)
                    model[key] = v  # acked only when the write returned
                break
            except ShardDownError as e:
                counters["denied_ops"] += 1
                if attempt:
                    raise
                g = store.group(e.shard)
                if g.primary_down and not all(g.down[1:]):
                    store.failover(e.shard)  # promote and retry
                    counters["failovers"] += 1
                else:
                    _heal(e.shard)  # quorum lost below promotable: rebuild
        if op == "read":
            n_reads += 1
        else:
            n_writes += 1
    # return to full strength, then verify EVERY acked write one last time
    for sh in getattr(store, "shard_ids", range(store.n_shards)):
        g = store.group(sh)
        if g.primary_down or g.live_count < len(g.replicas) or \
                len(g.replicas) < cluster.replication:
            _heal(sh)
    for k, v in model.items():
        got = store.read(k)
        if got != v:
            raise RuntimeError(f"lost acked write on key {k}")
    stats = dict(store.stats)
    return {"workload": workload, "n_ops": len(ops), "n_keys": n_keys,
            "reads": n_reads, "writes": n_writes,
            "plan": plan.describe(), "seed": plan.seed,
            "faults": len(plan.faults),
            # the acceptance pair: any violation raised instead, so a
            # returned report always carries zeros — CI asserts them
            "lost_acked_writes": 0, "stale_reads": 0,
            "epoch_bumps": cluster.epoch_bumps,
            "degraded_reads": cluster.degraded_reads,
            "stale_rejected": cluster.stale_rejected,
            **counters,
            "spec_hits": stats.get("spec_hits", 0),
            "spec_misses": stats.get("spec_misses", 0),
            "store_stats": stats}


# ------------------------------------------- elastic scale-out/in under load
def run_elastic_workload(store, workload: str = "ycsb_a", n_ops: int = 600,
                         n_keys: int = 120, value_size: int = 64,
                         seed: int = 0, step_budget: int = 8,
                         delete_every: int = 13, grace: int = 1) -> dict:
    """THE online-resharding acceptance scenario: drive a replicated cluster
    store with a YCSB op stream while the cluster scales OUT twice and IN
    three times mid-stream (e.g. 4 → 6 → 3 shards), every migration
    interleaved with live traffic.

    Each membership change starts with ``run=False`` and the driver calls
    ``Resharding.step(step_budget)`` after every client op, so reads hit the
    dual-fetch path on in-flight slices, writes land on new owners behind
    per-slice epoch-fenced cutovers, and deletes (every ``delete_every``-th
    write becomes one) plant tombstones that migration must NOT resurrect.

    The first scale-out also injects a straggler: a partitioned write is
    started against a migrating slice's OLD owner before the cutover, and
    its data-leg doorbells ring only after ``bump_epoch`` fenced the group —
    every leg must be REJECTED (split-brain safety at the resharding
    boundary), after which the driver retries through the new owner.

    Every read is checked against the dict model of ACKNOWLEDGED writes and
    a final sweep re-verifies all keys (including that deleted keys stay
    deleted) after the last migration drains — so a returned report always
    carries ``lost_acked_writes == 0`` and ``stale_reads == 0``; any
    violation raised instead.  Per-event bytes-moved is compared against the
    minimal keyspace fraction (the CI criterion asserts the ratio ≤ 1.5)."""
    cluster = store.cluster
    if cluster.replication < 2:
        raise ValueError("run_elastic_workload needs a replicated cluster "
                         "(the straggler injection rides a write quorum)")
    ops = make_ops(workload, n_ops, n_keys, seed)
    rng = np.random.default_rng(seed + 2)
    model = {}
    for k in range(n_keys):  # load phase (keys 1-based; 0 is the empty slot)
        v = rng.bytes(value_size)
        store.write(k + 1, v)
        model[k + 1] = v
    deleted: set = set()
    # membership plan: two scale-outs early, three scale-ins later — the
    # cluster ends SMALLER than it started, so shrink is exercised on shards
    # that were themselves added mid-run
    events = {n_ops * 1 // 8: "add", n_ops * 2 // 8: "add",
              n_ops * 4 // 8: "remove", n_ops * 5 // 8: "remove",
              n_ops * 6 // 8: "remove"}
    shards_path = [store.n_shards]
    migrations: List[dict] = []
    straggler_rejections = 0
    first_add = True
    n_reads = n_writes = n_deletes = dual_reads = 0

    def _finish_active() -> None:
        rs = store.resharding
        if rs is not None:
            rs.run_to_completion()
            _harvest(rs)

    def _harvest(rs) -> None:
        nonlocal dual_reads
        rep = rs.report()
        minimal = rep["moved_fraction"] * len(model) * value_size
        migrations[-1].update(
            moved_fraction=round(rep["moved_fraction"], 4),
            bytes_moved=rep["bytes_moved"], keys_copied=rep["keys_copied"],
            cutovers=rep["cutovers"], dual_reads=rep["dual_reads"],
            tombstones=rep["tombstones"],
            cleanup_removed=rep["cleanup_removed"],
            minimal_bytes=round(minimal, 1),
            ratio=round(rep["bytes_moved"] / minimal, 3) if minimal else 0.0)
        dual_reads += rep["dual_reads"]
        shards_path.append(store.n_shards)

    def _begin(op: str) -> None:
        nonlocal straggler_rejections, first_add
        _finish_active()  # one migration at a time
        if op == "add":
            rs = store.add_shard(run=False, grace=grace)
            migrations.append({"op": "add", "shard": rs.adding})
            if first_add:
                first_add = False
                straggler_rejections += _inject_straggler(rs)
        else:
            victim = min(store.shard_ids)
            rs = store.remove_shard(victim, run=False, grace=grace)
            migrations.append({"op": "remove", "shard": victim})

    def _inject_straggler(rs) -> int:
        """Pre-cutover partitioned write against the first slice's OLD
        owner; ring its data legs after the cutover fenced the epoch."""
        s0 = rs.slices[0]
        k = n_keys + 1
        while not s0.contains_key(k):
            k += 1
        g = store.group(s0.src)
        w = g.begin_partitioned_write(k, rng.bytes(value_size))
        rs.step(step_budget)  # performs the slice-0 cutover (bump_epoch)
        outcomes = w.ring()   # stale-epoch WQEs finally reach the NICs
        if w.acked:
            raise RuntimeError(
                f"straggler write acked across a resharding cutover "
                f"({outcomes})")
        # un-acked → not in the model; retry through the (new) owner
        v = rng.bytes(value_size)
        store.write(k, v)
        model[k] = v
        return outcomes.count("rejected")

    for i, (op, key) in enumerate(ops):
        if i in events:
            _begin(events[i])
        key += 1
        if op == "read":
            n_reads += 1
            got = store.read(key)
            if got != model.get(key):  # must check even under -O
                raise RuntimeError(f"stale read on key {key}")
        elif model.get(key) is not None and n_writes % delete_every == delete_every - 1:
            n_deletes += 1
            n_writes += 1
            store.delete(key)
            del model[key]
            deleted.add(key)
        else:
            n_writes += 1
            v = rng.bytes(value_size)
            store.write(key, v)
            model[key] = v
            deleted.discard(key)
        rs = store.resharding
        if rs is not None:
            rs.step(step_budget)
            if rs.done:
                _harvest(rs)
    _finish_active()
    # final sweep: every acked write survives every migration, and deleted
    # keys stay deleted (migration resurrected nothing)
    for k, v in model.items():
        if store.read(k) != v:
            raise RuntimeError(f"lost acked write on key {k}")
    for k in deleted:
        if k not in model and store.read(k) is not None:
            raise RuntimeError(f"deleted key {k} resurrected by migration")
    stats = dict(store.stats)
    return {"workload": workload, "n_ops": len(ops), "n_keys": n_keys,
            "reads": n_reads, "writes": n_writes, "deletes": n_deletes,
            "shards_path": shards_path, "migrations": migrations,
            # the acceptance pair: any violation raised instead, so a
            # returned report always carries zeros — CI asserts them
            "lost_acked_writes": 0, "stale_reads": 0,
            "dual_reads": dual_reads,
            "bytes_moved": sum(m["bytes_moved"] for m in migrations),
            "minimal_bytes": round(sum(m["minimal_bytes"]
                                       for m in migrations), 1),
            "max_ratio": max(m["ratio"] for m in migrations),
            "straggler_rejections": straggler_rejections,
            "stale_rejected": cluster.stale_rejected,
            "spec_invalidations": stats.get("spec_invalidations", 0),
            "store_stats": stats}
