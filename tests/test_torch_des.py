"""The port's DES (``netsim/``, ``fabric/sim.py``) against the JAX package's:
the event loop on scripted event orders, and the step and doorbell traces
that ``SimTransport`` captures off the real store code, compared exactly.
Also the port's own check of the paper's calibration (Erda read ≈ 62 µs,
Redo and RAW ≈ 92 µs; Erda reads use no server CPU)."""
import numpy as np
import pytest

from torch_des_parity import (assert_same, clear_loc_caches, mod, on_cpu,
                              sim_store, take)

SIZES = [16, 64, 256, 1024, 4096]


# ---------------------------------------------------------- the event loop
def scripted_events(pkg: str) -> dict:
    """Ties at one instant, a 2-worker Resource with a queue, a FifoLock
    held across delays by three processes, and a closed-loop client."""
    S = mod(pkg, "netsim.sim")
    sim = S.Simulator()
    log = []
    for i, t in enumerate([3e-6, 1e-6, 1e-6, 0.0, 2e-6]):
        sim.at(t, lambda i=i: log.append(("at", i, sim.now)))
    sim.after(1e-6, lambda: sim.after(0.0, lambda: log.append(("nested", sim.now))))
    cpu = S.Resource(sim, 2, "cpu")
    for i, s in enumerate([4e-6, 1e-6, 2e-6, 3e-6, 1e-6]):
        cpu.request(s, lambda i=i: log.append(("cpu", i, sim.now)))
    qp = S.FifoLock(sim, "qp0")

    def chain(i, hold):
        yield ("lock", qp)
        yield ("delay", hold)
        yield ("acquire", cpu, 5e-7)
        yield ("unlock", qp)
        yield ("delay", 1e-7 * i)
    for i, hold in enumerate([2e-6, 1e-6, 3e-6]):
        S.run_process(sim, chain(i, hold), lambda i=i: log.append(("chain", i, sim.now)))
    issued = []

    def op_factory():  # a kinded read, then a bare op on the CPU, in turn
        issued.append(len(issued))
        if len(issued) % 2:
            return "read", iter([("delay", 2e-6)])
        return iter([("acquire", cpu, 1e-6)])
    client = S.ClosedLoopClient(sim, op_factory, horizon_s=9e-6)
    client.start()
    sim.run(until=2e-5)
    return {"log": log, "now": sim.now, "cpu": (cpu.busy_seconds, cpu.completed,
                                                 cpu.utilization(2e-5)),
            "qp": (qp.stats(), qp.queue_depth),
            "client": (client.records, client.completed)}


def test_simulator_resource_fifolock_event_order():
    out = assert_same(scripted_events)
    assert out["qp"][0]["wait_events"] == 2 and out["client"][1] > 0


def scripted_verbs(pkg: str) -> list:
    """``netsim.Verbs`` ops from two processes contending for one CPU."""
    N = mod(pkg, "netsim")
    sim = N.Simulator()
    p = N.SimParams()
    v = N.Verbs(sim, p, N.Resource(sim, 1))
    done = []

    def op(i):
        yield from v.one_sided_read(64 * (i + 1))
        yield from v.send_recv(2e-6 * (i + 1), req_bytes=128, resp_bytes=256)
        v.cpu_async(1e-6)
        yield from v.one_sided_write(1024)
    for i in range(2):
        N.run_process(sim, op(i), lambda i=i: done.append((i, sim.now)))
    sim.run()
    return [done, v.cpu.busy_seconds, v.nvm_write_s(64)]


def test_verbs_match_reference():
    assert_same(scripted_verbs)


# ------------------------------------------------------ SimTransport traces
def store_ops(pkg: str, scheme: str, vsize: int) -> list:
    """Every verb trace of a store's single-key and batched ops: create,
    update, cold and warm reads, a read after another client's larger
    update (speculative miss and size miss on Erda), multi_write,
    multi_read, delete and a read of the deleted key."""
    store = sim_store(pkg, scheme)
    value, bigger = b"\xa5" * vsize, b"\x5a" * (2 * vsize)
    out = []

    def rec(label, result=None):
        out.append((label, result, take(store)))
    store.write(11, value)
    rec("create")
    store.write(11, value)
    rec("update")
    clear_loc_caches(store)
    rec("cold_read", store.read(11))
    rec("warm_read", store.read(11))
    if scheme == "erda":
        other = mod(pkg, "core.client").ErdaClient(store.server, client_id=99,
                                                    **on_cpu(pkg))
        other.write(11, bigger)
    else:
        store.write(11, bigger)
    rec("stale_read", store.read(11))
    store.multi_write([(k, bytes([k]) * vsize) for k in range(1, 6)])
    rec("multi_write")
    clear_loc_caches(store)
    rec("multi_read_cold", store.multi_read([1, 2, 3, 4, 5, 11, 77]))
    rec("multi_read_warm", store.multi_read([5, 4, 3, 11]))
    store.delete(11)
    rec("delete")
    rec("read_deleted", store.read(11))
    out.append(("stats", dict(getattr(store, "stats", {}))))
    return out


@pytest.mark.parametrize("scheme", ["erda", "redo", "raw"])
@pytest.mark.parametrize("vsize", SIZES)
def test_sim_transport_traces_match_reference(scheme, vsize):
    out = assert_same(store_ops, scheme, vsize)
    labels = {label: rest for label, *rest in out}
    assert labels["cold_read"][0] == b"\xa5" * vsize
    assert labels["stale_read"][0] == b"\x5a" * (2 * vsize)
    if scheme == "erda":
        stats = labels["stats"][0]
        assert stats["spec_hits"] > 0 and stats["spec_misses"] > 0


def cluster_ops(pkg: str, vsize: int, replication: int) -> list:
    """A 3-shard erda-cluster over SimTransport: a batched read's per-shard
    lanes (each shard's batch verified at once in the port), single reads
    and a mirrored write."""
    store = sim_store(pkg, "erda-cluster", n_shards=3, replication=replication)
    items = [(k, bytes([k]) * (vsize + k)) for k in range(1, 13)]
    store.multi_write(items)
    out = [take(store)]
    clear_loc_caches(store)
    out.append((store.multi_read([k for k, _ in items] + [99]), take(store)))
    out.append((store.multi_read([3, 1, 2]), take(store)))
    out.append((store.read(7), take(store)))
    store.write(7, b"w" * vsize)
    out.append(take(store))
    return out


@pytest.mark.parametrize("vsize,replication", [(64, 1), (256, 2)])
def test_cluster_batched_read_traces_match_reference(vsize, replication):
    assert_same(cluster_ops, vsize, replication)


def sim_transport_verbs(pkg: str) -> list:
    """The five verbs through ``make_transport("sim", dev)``."""
    t = mod(pkg, "fabric").make_transport("sim", mod(pkg, "nvmsim.device").NVMDevice(1 << 16))
    t.one_sided_write(64, b"abc", op="x")
    got = [type(t).__name__, t.one_sided_read(64, 3, op="x")]
    t.atomic_word_write(128, 7, op="x")
    got += [t.send_recv("erda.read", lambda: b"r" * 40),
            t.write_with_imm("x.imm", lambda: 1)]
    return got + [t.take_steps(), t.take_doorbells(), t.counts]


def test_make_transport_sim_returns_a_sim_transport():
    from repro_torch.fabric import SimTransport, make_transport
    from repro_torch.nvmsim.device import NVMDevice
    assert type(make_transport("sim", NVMDevice(1 << 16))) is SimTransport
    out = assert_same(sim_transport_verbs)
    assert out[:2] == ["SimTransport", b"abc"]
    assert {k for k, _ in out[4]} == {"delay", "cpu"}


# --------------------------------------------- pricing and the contended replay
def contention_scenario(pkg: str) -> dict:
    """Captured doorbell traces through the pricing closed forms and the
    contended replay (``ServerPort``, per-QP ``FifoLock``, ``OpHandle``)."""
    C = mod(pkg, "netsim.contention")
    P = mod(pkg, "netsim.pricing")
    S = mod(pkg, "netsim.sim")
    p = P.SimParams()
    store = sim_store(pkg, "erda")
    store.write(5, b"a" * 256)
    take(store)
    store.write(5, b"b" * 256)
    write = take(store)[0][1]
    clear_loc_caches(store)
    store.read(5)
    read = take(store)[0][1]
    store.multi_write([(k, b"c" * 64) for k in range(1, 9)])
    mw = take(store)[0][1]
    traces = [read, write, mw, read]
    sim = S.Simulator()
    port = C.ServerPort(sim, p)
    qp = S.FifoLock(sim, "qp")
    handles = [C.OpHandle() for _ in traces]
    done = []
    for h, tr in zip(handles, traces):
        S.run_process(sim, C.replay_doorbells(tr, qp, port, h),
                      lambda h=h: (h.complete(sim.now), done.append(sim.now)))
    sim.run()
    est = C.QPServiceEstimator(P.trace_completion_s(p, read), floor_s=1e-6)
    for gap in (5e-5, 2e-5, 8e-5):
        est.observe(gap)
    chain = [ev for ev in mw if isinstance(ev, P.DoorbellTrace)][0]
    return {"done": done, "port": port.stats(sim.now),
            "handles": [(h.completed_at, h.durable_at, h.persist_lag_s())
                        for h in handles],
            "qp": C.qp_stats_summary({"qp": qp}),
            "contended_us": C.contended_latency_us([read, write, mw, mw], p),
            "uncontended_us": [C.doorbell_trace_latency_us(t, p) for t in traces],
            "nic_s": [C.trace_nic_occupancy_s(t, p) for t in traces],
            "estimate": (est.estimate_completion_s(1e-4, 3), est.stats()),
            "chain": (P.chain_steps(p, list(chain.wrs)),
                      P.chain_completion_s(p, list(chain.wrs)),
                      P.chain_nic_occupancy_s(p, list(chain.wrs))),
            "quorum": P.quorum_times_s([(3e-6, 9e-6), (1e-6, 12e-6),
                                        (2e-6, 4e-6)], 2)}


def test_contended_replay_and_pricing_match_reference():
    out = assert_same(contention_scenario)
    assert len(out["done"]) == 4 and out["quorum"] == (2e-6, 9e-6)


# --------------------------------------------- the paper's calibration, ported
def op_steps(scheme: str, op: str, vsize: int) -> list:
    """The DES steps of one cold read or one update of ``scheme`` in the
    port, captured off its store code over SimTransport."""
    store = sim_store("repro_torch", scheme)
    value = b"\xa5" * vsize
    store.write(11, value)
    store.write(11, value)
    clear_loc_caches(store)
    take(store)
    assert store.read(11) == value
    read = take(store)[0][0]
    store.write(11, value)
    return {"read": read, "write": take(store)[0][0]}[op]


def latency_us(scheme: str, op: str, vsize: int) -> float:
    from repro_torch.fabric import steps_latency_s
    return steps_latency_s(op_steps(scheme, op, vsize)) * 1e6


def cpu_us(scheme: str, op: str, vsize: int) -> float:
    from repro_torch.fabric import steps_cpu_s
    return steps_cpu_s(op_steps(scheme, op, vsize)) * 1e6


def test_port_reproduces_paper_read_averages():
    """Erda read ≈ 62 µs, baseline read ≈ 92 µs (paper: 62.84 / 92.7),
    simulated, off the port's protocol code."""
    erda, redo, raw = (float(np.mean([latency_us(s, "read", v) for v in SIZES]))
                       for s in ("erda", "redo", "raw"))
    assert erda == pytest.approx(62.0, abs=4.0)
    assert redo == pytest.approx(92.0, abs=4.0)
    assert raw == pytest.approx(92.0, abs=4.0)
    assert erda < redo


def test_port_sim_cpu_asymmetry():
    """Erda reads use no server CPU; its writes less than Redo's."""
    assert cpu_us("erda", "read", 1024) == 0.0
    assert cpu_us("redo", "read", 1024) > 0.0
    assert 0.0 < cpu_us("erda", "write", 1024) < cpu_us("redo", "write", 1024)


def test_port_sim_steps_cover_all_kinds():
    from repro_torch.fabric import steps_cpu_s, steps_latency_s
    s = sim_store("repro_torch", "redo")
    s.write(1, b"z" * 256)
    steps = s.transport.take_steps()
    assert {k for k, _ in steps} == {"delay", "cpu", "cpu_async"}
    assert steps_latency_s(steps) > 0 and steps_cpu_s(steps) > 0
