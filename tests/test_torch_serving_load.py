"""The port's serving at load (``serving/load.py``, ``serve_kv_at_load``)
against the JAX package's: page-fetch and migration traces captured off real
``ErdaCluster`` ops, the open-loop runs' reports and event traces with
shared-QP coalescing, SLO deadlines and both admissions, and the schedules
it dispatches, all equal exactly."""
import pytest
import torch

from torch_des_parity import assert_same, canon, mod, on_cpu, server_config

#: the at-load settings of ``examples/serve_kv.py`` and
#: ``tests/test_serving_slo.py``, at short horizons
LOADS = [dict(offered_kops=120, n_clients=8, coalesce=False),
         dict(offered_kops=900, n_clients=8),
         dict(offered_kops=900, n_clients=8, share_qp=True, slo_us=250,
              admission="slo", seed=4),
         dict(offered_kops=2400, n_clients=8, share_qp=True, b_max=16,
              slo_us=250, admission="queue", seed=1)]


def page_traces(pkg: str, replication: int, batches=(1, 2, 4, 8)):
    return mod(pkg, "serving.load").capture_page_fetch_traces(
        **on_cpu(pkg, n_shards=2, batches=batches, replication=replication))


@pytest.mark.parametrize("replication", [1, 3])
def test_page_fetch_traces_match_reference(replication):
    out = assert_same(page_traces, replication)
    assert sorted(out["read"]) == [1, 2, 4, 8]
    assert out["meta"]["replication"] == replication
    assert (out["meta"]["mirror_wqes"][8] > 0) == (replication > 1)


def migration_traces(pkg: str):
    return mod(pkg, "serving.load").capture_migration_traces(
        **on_cpu(pkg, n_shards=3, n_keys=24, vsize=256))


def test_migration_traces_match_reference():
    assert assert_same(migration_traces)


def at_load(pkg: str, load: dict, *, horizon_s: float = 0.002) -> dict:
    """``serve_kv_at_load`` with its event trace and dispatched schedule."""
    fn = mod(pkg, "serving.engine").serve_kv_at_load
    return fn(**on_cpu(pkg, **load), n_shards=2, horizon_s=horizon_s,
              capture_batches=(1, 2, 4, 8, 16), collect_trace=True,
              collect_schedule=True)


@pytest.mark.parametrize("load", LOADS, ids=lambda d: "-".join(map(str, d.values())))
def test_serve_kv_at_load_matches_reference(load):
    ref, port = (at_load(pkg, load) for pkg in ("repro", "repro_torch"))
    assert canon(port) == canon(ref)
    L = mod("repro_torch", "serving.load")
    assert L.event_trace_bytes(port) == mod("repro", "serving.load").event_trace_bytes(ref)
    assert port["completed"] > 0 and port["event_trace"]
    legal = L.check_schedule_legality(port["schedule_detail"], load["n_clients"])
    assert legal["violations"] == 0
    assert legal == mod("repro", "serving.load").check_schedule_legality(
        ref["schedule_detail"], load["n_clients"])


def open_loop_sweep(pkg: str) -> list:
    """``run_open_loop`` / ``sweep_open_loop`` on replicated traces, with
    a resharding cutover and background migration chains."""
    L = mod(pkg, "serving.load")
    p = mod(pkg, "netsim.pricing").SimParams()
    traces = page_traces(pkg, 2)
    moved = page_traces(pkg, 1)
    chains = L.capture_migration_traces(**on_cpu(pkg, n_shards=2, n_keys=12,
                                                 vsize=128))
    cfg = L.OpenLoopConfig(offered_kops=600, n_clients=4, horizon_s=0.0015,
                           share_qp=True, read_frac=0.7, seed=2,
                           collect_trace=True)
    reshard = L.run_open_loop(traces, cfg, p, lane_events=[(5e-4, moved)],
                              background=[(2e-4 + 1e-5 * i, port, tr)
                                          for i, (port, tr) in enumerate(chains)])
    return [reshard] + L.sweep_open_loop(traces, [100, 800], p, n_clients=4,
                                         horizon_s=0.001, read_frac=0.8)


def test_open_loop_with_resharding_and_sweep_matches_reference():
    out = assert_same(open_loop_sweep)
    assert out[0]["lane_events"] == 1 and out[0]["background_chains"]["injected"] > 0


def validated_schedule(pkg: str) -> dict:
    """The schedule a shared-QP run dispatched, replayed against a real
    functional store on the CPU."""
    report = at_load(pkg, LOADS[2])
    cfg = server_config(pkg, device_size=16 << 20, table_capacity=1 << 10,
                        n_heads=1, region_size=2 << 20, segment_size=64 << 10)
    store = mod(pkg, "core").make_store("erda-cluster", **on_cpu(pkg, n_shards=2,
                                                                 cfg=cfg))
    return mod(pkg, "serving.load").validate_schedule(
        store, report["schedule"], n_keys=512, value_size=32)


def test_validate_schedule_matches_reference():
    out = assert_same(validated_schedule)
    assert out["stale_or_lost"] == 0 and out["reads"] > 0


def test_trace_cache_keys_on_the_device():
    """A capture made on the CPU never serves a call for the card: the key
    holds the device, and asking for CUDA without a card still raises."""
    from repro_torch.serving import engine
    engine.serve_kv_at_load(100, horizon_s=0.0005, n_shards=2, vsize=64,
                            capture_batches=(1, 2), device="cpu")
    assert any("cpu" in key for key in engine._page_traces)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            engine.serve_kv_at_load(100, horizon_s=0.0005, n_shards=2, vsize=64,
                                    capture_batches=(1, 2))


def test_serving_exports_cover_the_reference():
    import repro.serving as R
    import repro_torch.serving as T
    assert set(R.__all__) <= set(T.__all__)
    for name in ("serve_kv_at_load", "run_open_loop", "QPScheduler",
                 "capture_page_fetch_traces", "event_trace_bytes"):
        assert getattr(T, name).__module__.startswith("repro_torch.")
