"""The port's YCSB workloads (``workloads/``) against the JAX package's: the
op streams and fault plans, ``run_store_workload`` over every store (batched,
unbatched and contended on the DES) and the failover, chaos and elastic
workloads, whose reports must be equal exactly.  The workloads check every
read against their model of acknowledged writes and raise on a mismatch, so
a returned report is itself the guarantee."""
import pytest

from torch_des_parity import (assert_same, canon, mod, on_cpu, server_config,
                              sim_factory)

#: ``tests/test_replication.py``'s and ``tests/test_resharding.py``'s shard
#: geometry
CFG = dict(device_size=16 << 20, table_capacity=1 << 10, n_heads=2,
           region_size=1 << 20, segment_size=32 << 10)
#: the quorum chaos runs' geometry: every heal and promotion pays a §4.2
#: scan of each head's regions, 8 bytes a step on the host in both packages,
#: so the regions are a quarter of ``tests/fault_plan.py``'s
CHAOS_CFG = dict(CFG, device_size=4 << 20, region_size=256 << 10)


def ops_and_plans(pkg: str) -> dict:
    Y = mod(pkg, "workloads.ycsb")
    F = mod(pkg, "workloads.faults")
    zipf = Y.ZipfianGenerator(1000, seed=4)
    return {"zipf": zipf.sample(64).tolist(), "zipf_state": (zipf.zetan, zipf.eta),
            "ops": {w: Y.make_ops(w, 200, 50, seed=s)
                    for s, w in enumerate(sorted(Y.WORKLOADS))},
            "plans": [F.FaultPlan.generate(seed=s, n_ops=300, n_shards=n, replication=r,
                                           n_faults=f).describe()
                      for s, n, r, f in ((0, 2, 3, 6), (5, 3, 2, 4), (9, 4, 3, 8))]}


def test_ops_zipfian_and_fault_plans_match_reference():
    out = assert_same(ops_and_plans)
    assert {op for op, _ in out["ops"]["ycsb_c"]} == {"read"}


def make(pkg: str, scheme: str, *, sim: bool, **kw):
    """``scheme``'s store at the test geometry, over ``SimTransport`` where
    ``sim`` (the contended replay captures its doorbells)."""
    if sim:
        kw["transport_factory"] = sim_factory(pkg)
    make_store = mod(pkg, "core").make_store
    if scheme == "redo":
        return make_store("redo", **on_cpu(pkg, device_size=16 << 20,
                                           redo_capacity=1 << 20, **kw))
    if scheme == "raw":
        return make_store("raw", **on_cpu(pkg, device_size=16 << 20,
                                          ring_capacity=1 << 20, **kw))
    return make_store(scheme, **on_cpu(pkg, cfg=server_config(pkg, **CFG), **kw))


def store_workload(pkg: str, scheme: str, workload: str, batch: int,
                   threads: int) -> dict:
    kw = {"n_shards": 4} if scheme == "erda-cluster" else {}
    store = make(pkg, scheme, sim=bool(threads), **kw)
    return mod(pkg, "workloads.ycsb").run_store_workload(
        store, workload, n_ops=240, n_keys=48, value_size=64, seed=1,
        batch_size=batch, contended_threads=threads)


@pytest.mark.parametrize("scheme", ["erda", "erda-cluster", "redo", "raw"])
@pytest.mark.parametrize("workload,batch,threads", [("ycsb_a", 0, 0),
                                                    ("ycsb_b", 8, 0),
                                                    ("ycsb_a", 8, 4)])
def test_store_workload_matches_reference(scheme, workload, batch, threads):
    out = assert_same(store_workload, scheme, workload, batch, threads)
    assert out["reads"] + out["writes"] == 240
    if threads:
        assert out["contended"]["ops_replayed"] > 0


def test_contended_ycsb_c_on_a_cluster_matches_reference():
    """ycsb_c unbatched over a 4-shard cluster with 8 contended threads:
    every op a CRC-verified single read."""
    def run(pkg):
        store = make(pkg, "erda-cluster", sim=True, n_shards=4)
        return mod(pkg, "workloads.ycsb").run_store_workload(
            store, "ycsb_c", n_ops=200, n_keys=40, value_size=64,
            contended_threads=8)
    out = assert_same(run)
    assert out["reads"] == 200 and out["contended"]["n_threads"] == 8


def failover(pkg: str) -> dict:
    """``tests/test_replication.py``'s kill-a-shard acceptance run."""
    store = make(pkg, "erda-cluster", sim=False, n_shards=4, replication=2)
    return mod(pkg, "workloads.ycsb").run_failover_workload(
        store, "ycsb_a", n_ops=600, n_keys=80, value_size=64, seed=3)


def test_failover_workload_matches_reference():
    out = assert_same(failover)
    assert out["failovers"] == 1 and out["denied_ops"] >= 1
    assert out["reads"] + out["writes"] == 600


def chaos(pkg: str, seed: int) -> dict:
    """A quorum chaos run (replication 3) at ``CHAOS_CFG``, shortened."""
    make_store = mod(pkg, "core").make_store
    store = make_store("erda-cluster", **on_cpu(pkg, n_shards=2, replication=3,
                                                cfg=server_config(pkg, **CHAOS_CFG)))
    return mod(pkg, "workloads.ycsb").run_chaos_workload(
        store, "ycsb_a", n_ops=150, n_keys=24, seed=seed, n_faults=5)


@pytest.mark.parametrize("seed", [0, 7])
def test_chaos_workload_matches_reference(seed):
    out = assert_same(chaos, seed)
    assert out["lost_acked_writes"] == 0 and out["stale_reads"] == 0
    assert out["faults"] == 5


def elastic(pkg: str) -> dict:
    """Scale-out and scale-in under load, shortened."""
    store = make(pkg, "erda-cluster", sim=False, n_shards=4, replication=2)
    return mod(pkg, "workloads.ycsb").run_elastic_workload(
        store, n_ops=300, n_keys=60)


def test_elastic_workload_matches_reference():
    out = assert_same(elastic)
    assert out["lost_acked_writes"] == 0 and out["stale_reads"] == 0
    assert len(out["migrations"]) == 5 and out["straggler_rejections"] >= 1


def test_read_mismatch_raises_in_the_port():
    """A store that returns a wrong value fails the workload's read check, as
    in the reference."""
    from repro_torch.workloads import run_store_workload
    store = make("repro_torch", "erda", sim=False)
    real = store.read
    store.read = lambda k: b"wrong" if k == 3 else real(k)
    with pytest.raises(RuntimeError, match="mismatch"):
        run_store_workload(store, "ycsb_c", n_ops=200, n_keys=4, value_size=16)


def test_workloads_exports_match_reference():
    import repro.workloads as R
    import repro_torch.workloads as T
    assert T.__all__ == R.__all__
    assert canon(sorted(T.WORKLOADS.items())) == canon(sorted(R.WORKLOADS.items()))
