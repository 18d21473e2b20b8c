"""The port's Erda KV page store against the JAX package's: the reference's
page-store scenarios on the port, failover, and pages crossing between the
packages within one process."""
import ml_dtypes
import numpy as np
import torch

from repro.core import ErdaStore as RStore
from repro.core import ServerConfig as RConfig
from repro.core import make_store as r_make_store
from repro.core.client import ErdaClient as RClient
from repro.serving import ErdaKVPageStore as RPages
from repro_torch.checkpoint.serialization import tree_from_numpy
from repro_torch.core import ErdaStore as TStore
from repro_torch.core import ServerConfig as TConfig
from repro_torch.core import make_store as t_make_store
from repro_torch.core.client import ErdaClient as TClient
from repro_torch.serving import ErdaKVPageStore as TPages
from repro_torch.tree import flatten_with_path

CFG = dict(device_size=32 << 20, table_capacity=1 << 11, n_heads=2,
           region_size=1 << 20, segment_size=256 << 10)


def pages(n_shards=2, replication=1):
    return TPages(t_make_store("erda-cluster", n_shards=n_shards,
                               replication=replication, cfg=TConfig(**CFG),
                               device="cpu"), device="cpu")


def t(a):
    return tree_from_numpy(a, "cpu")


def test_page_roundtrip():
    store = pages()
    arr = t(np.random.default_rng(0).standard_normal((4, 8, 16)).astype(np.float32))
    store.put_page(1, "k", 0, arr)
    got = store.get_page(1, "k", 0)
    assert torch.equal(got, arr)
    assert store.get_page(1, "k", 99) is None
    store.drop_page(1, "k", 0)
    assert store.get_page(1, "k", 0) is None


def test_snapshot_restore_cache_pytree():
    store = pages()
    cache = {"pos": torch.tensor(5, dtype=torch.int32),
             "full": {"k": torch.arange(24, dtype=torch.float32).reshape(2, 3, 4),
                      "kv_pos": torch.arange(3, dtype=torch.int32)},
             "pages": [t(np.ones((2, 2), ml_dtypes.bfloat16) * i) for i in range(3)]}
    assert store.snapshot_cache(7, cache) == 6
    got = store.restore_cache(7, cache)
    assert int(got["pos"]) == 5 and got["pos"].dtype == torch.int32
    for (p, a), (_q, b) in zip(flatten_with_path(got), flatten_with_path(cache)):
        assert a.dtype == b.dtype and torch.equal(a, b), p
    assert store.restore_cache(8, cache) is None


def test_compaction_preserves_pages():
    store = pages()
    rng = np.random.default_rng(3)
    arrays = {}
    for i in range(40):
        a = t(rng.standard_normal((32, 32)).astype(np.float32))
        store.put_page(1, "kv", i, t(rng.standard_normal((32, 32)).astype(np.float32)))
        store.put_page(1, "kv", i, a)
        arrays[i] = a
    store.compact()
    got = store.get_pages(1, "kv", list(arrays))
    for i, a in arrays.items():
        assert torch.equal(got[i], a)


def test_failover_keeps_mirrored_pages():
    store = pages(n_shards=2, replication=2)
    rng = np.random.default_rng(4)
    cache = {"k": [t(rng.standard_normal((4, 8)).astype(np.float32)) for _ in range(24)]}
    store.snapshot_cache(3, cache)
    store.fail_shard(0)
    got = store.restore_cache(3, cache)  # degraded quorum reads on backups
    assert all(torch.equal(a, b) for a, b in zip(got["k"], cache["k"]))
    info = store.failover(0)
    assert info["promotions"] == 1
    got = store.restore_cache(3, cache)
    assert all(torch.equal(a, b) for a, b in zip(got["k"], cache["k"]))
    assert store.stats["fallbacks"] == 0


def test_same_snapshot_leaves_identical_nvm_as_reference():
    rng = np.random.default_rng(5)
    cache = {"k": [rng.standard_normal((4, 8)).astype(np.float32) for _ in range(12)],
             "pos": np.asarray(np.int32(9))}
    ref = RPages(r_make_store("erda-cluster", n_shards=2, replication=2,
                              cfg=RConfig(**CFG)))
    port = pages(n_shards=2, replication=2)
    ref.snapshot_cache(1, cache)
    port.snapshot_cache(1, t(cache))
    rdevs = [r.server.dev for g in ref.store.cluster.groups for r in g.replicas]
    tdevs = [r.server.dev for g in port.store.cluster.groups for r in g.replicas]
    for a, b in zip(rdevs, tdevs):
        assert np.array_equal(a.mem, b.mem)
        assert vars(a.stats) == vars(b.stats)


def test_pages_cross_between_packages():
    """In one process, the port reads the pages the reference wrote, and the
    reverse, through clients connected to the other package's server."""
    rng = np.random.default_rng(6)
    a = rng.standard_normal((16, 2, 8)).astype(ml_dtypes.bfloat16)
    b = rng.standard_normal((3, 5)).astype(np.float32)

    rstore = RStore(RConfig(**CFG))
    RPages(rstore).put_page(2, "k", 0, a)
    tside = object.__new__(TStore)
    tside.server, tside.dev = rstore.server, rstore.dev
    tside.client = TClient(rstore.server, device="cpu")
    got = TPages(tside, device="cpu").get_pages(2, "k", [0, 1])
    assert torch.equal(got[0], t(a)) and got[1] is None

    tstore = TStore(TConfig(**CFG), device="cpu")
    TPages(tstore, device="cpu").put_page(2, "v", 0, t(b))
    rside = object.__new__(RStore)
    rside.server, rside.dev = tstore.server, tstore.dev
    rside.client = RClient(tstore.server)
    np.testing.assert_array_equal(RPages(rside).get_page(2, "v", 0), b)
