"""One seeded sequence of store operations on the JAX package's store and on
the port's (``device="cpu"``): equal reads, equal NVM bytes, equal NVMStats
and client counters, through torn writes, recovery, compaction and
failover."""
import dataclasses

import numpy as np
import pytest

from repro.core import ServerConfig as RConfig
from repro.core import make_store as r_make_store
from repro_torch.core import ServerConfig as TConfig
from repro_torch.core import make_store as t_make_store

CFG = dict(device_size=2 << 20, table_capacity=1 << 9, n_heads=2,
           region_size=128 << 10, segment_size=16 << 10)


def op_sequence(seed, n_ops=160, n_keys=24, failover_at=None):
    rng = np.random.default_rng(seed)
    keys = [int(k) for k in rng.integers(1, 2**62, size=n_keys)]
    ops = []
    for i in range(n_ops):
        if i == failover_at:
            ops += [("fail_shard", 0), ("read_all",), ("failover", 0)]
        r = rng.random()
        key = keys[int(rng.integers(0, n_keys))]
        if r < 0.40:
            ops.append(("write", key, rng.bytes(int(rng.integers(1, 60)))))
        elif r < 0.50:
            ops.append(("delete", key))
        elif r < 0.62:
            ops.append(("read", key))
        elif r < 0.74:
            ops.append(("multi_read",
                        [keys[int(j)] for j in rng.integers(0, n_keys, size=6)]))
        elif r < 0.84:
            ops.append(("multi_write",
                        [(keys[int(j)], rng.bytes(int(rng.integers(1, 40))))
                         for j in rng.integers(0, n_keys, size=4)]))
        elif r < 0.93:
            ops.append(("torn", key, rng.bytes(int(rng.integers(8, 60))),
                        float(rng.uniform(0.1, 0.9))))
        elif r < 0.97:
            ops.append(("recover",))
        else:
            ops.append(("compact",))
    ops += [("read_all",)] + [("read", k) for k in keys]
    return keys, ops


def primary_dev(store, key):
    if hasattr(store, "cluster"):
        return store.cluster.group_for_key(key).primary.server.dev
    return store.dev


def run(store, keys, ops):
    """Apply ``ops``; the observation list holds every read and the type of
    every exception an op raised."""
    obs = []
    for op in ops:
        kind = op[0]
        try:
            if kind == "write":
                store.write(op[1], op[2])
            elif kind == "delete":
                store.delete(op[1])
            elif kind == "read":
                obs.append(store.read(op[1]))
            elif kind == "multi_read":
                obs.append(store.multi_read(op[1]))
            elif kind == "multi_write":
                store.multi_write(op[1])
            elif kind == "torn":
                primary_dev(store, op[1]).fault.arm(countdown=0, fraction=op[3])
                store.write(op[1], op[2])
            elif kind == "recover":
                obs.append(sorted(store.recover().items()))
            elif kind == "compact":
                obs.append(store.compact())
            elif kind == "read_all":
                obs.append(store.multi_read(keys))
            elif kind == "fail_shard":
                store.fail_shard(op[1])
            elif kind == "failover":
                obs.append(sorted(store.failover(op[1]).items()))
        except Exception as e:  # the reference's outcome is part of the record
            obs.append(type(e).__name__)
        for dev in store.devs:
            dev.fault.armed = False
    return obs


def devices(store):
    if hasattr(store, "cluster"):
        return [r.server.dev for g in store.cluster.groups for r in g.replicas]
    return [store.dev]


def assert_same_state(ref, port):
    rdevs, tdevs = devices(ref), devices(port)
    assert len(rdevs) == len(tdevs)
    for a, b in zip(rdevs, tdevs):
        assert np.array_equal(a.mem, b.mem)
        assert dataclasses.astuple(a.stats) == dataclasses.astuple(b.stats)
    assert ref.stats == port.stats


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_erda_store_parity(seed):
    keys, ops = op_sequence(seed)
    ref = r_make_store("erda", cfg=RConfig(**CFG))
    port = t_make_store("erda", cfg=TConfig(**CFG), device="cpu")
    r_obs, t_obs = run(ref, keys, ops), run(port, keys, ops)
    assert t_obs == r_obs
    assert "TornWrite" in r_obs and any(o is None for o in r_obs)
    assert ref.stats["fallbacks"] > 0
    assert_same_state(ref, port)


@pytest.mark.parametrize("seed", [0, 1])
def test_erda_cluster_replicated_failover_parity(seed):
    keys, ops = op_sequence(seed + 10, n_ops=120, failover_at=70)
    kw = dict(n_shards=2, replication=2)
    ref = r_make_store("erda-cluster", cfg=RConfig(**CFG), **kw)
    port = t_make_store("erda-cluster", cfg=TConfig(**CFG), device="cpu", **kw)
    r_obs, t_obs = run(ref, keys, ops), run(port, keys, ops)
    assert t_obs == r_obs
    assert "TornWrite" in r_obs
    assert ref.cluster.groups[0].promotions == 1
    assert ref.cluster.degraded_reads > 0
    assert_same_state(ref, port)
    assert ref.cluster.replica_stats == port.cluster.replica_stats


def test_port_clients_verify_on_their_device():
    port = t_make_store("erda-cluster", cfg=TConfig(**CFG), device="cpu",
                        n_shards=2, replication=2)
    assert {str(c.device) for g in port.cluster.groups for c in g.replicas} == {"cpu"}
