"""The port's serialization and Erda checkpoint manager against the JAX
package's: identical bytes, the reference's checkpoint scenarios on the port,
and checkpoints crossing between the packages within one process."""
import json

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import ErdaCheckpointManager as RMgr
from repro.checkpoint import serialization as rser
from repro.core import ErdaStore as RStore
from repro.core import ServerConfig as RConfig
from repro.core.client import ErdaClient as RClient
from repro_torch.checkpoint import ErdaCheckpointManager as TMgr
from repro_torch.checkpoint import serialization as tser
from repro_torch.core import ErdaStore as TStore
from repro_torch.core import ServerConfig as TConfig
from repro_torch.core.client import ErdaClient as TClient
from repro_torch.nvmsim.device import TornWrite
from repro_torch.tree import flatten_with_path

CFG = dict(device_size=128 << 20, table_capacity=1 << 12, n_heads=2,
           region_size=8 << 20, segment_size=1 << 20)


def leaves_np():
    rng = np.random.default_rng(0)
    return {
        "f32": rng.standard_normal((3, 5)).astype(np.float32),
        "bf16": rng.standard_normal((4, 6)).astype(ml_dtypes.bfloat16),
        "i32": rng.integers(-9, 9, size=(7,)).astype(np.int32),
        "scalar_i32": np.asarray(np.int32(5)),
        "scalar_f32": np.asarray(np.float32(2.5)),
        "bool": np.array([True, False]),
        "empty": np.zeros((0, 3), np.float32),
    }


@pytest.mark.parametrize("name", sorted(leaves_np()))
def test_leaf_bytes_equal_reference_and_cross_decode(name):
    arr = leaves_np()[name]
    t = tser.tree_from_numpy(arr, "cpu")
    blob = tser.leaf_to_bytes(t)
    assert blob == rser.leaf_to_bytes(arr)
    assert blob == tser.leaf_to_bytes(arr)  # numpy leaves serialize alike
    back = rser.leaf_from_bytes(blob)       # reference decodes the port's bytes
    assert back.dtype == arr.dtype and back.shape == arr.shape
    np.testing.assert_array_equal(back, arr)
    got = tser.leaf_from_bytes(rser.leaf_to_bytes(arr), "cpu")  # and the reverse
    assert got.dtype == t.dtype and torch.equal(got, t)
    np.testing.assert_array_equal(tser.tree_to_numpy(got), arr)


def small_state_np(seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    return {
        "params": {"w1": (rng.standard_normal((64, 128)) * scale).astype(np.float32),
                   "emb": {"table": (rng.standard_normal((100, 32)) * scale)
                           .astype(ml_dtypes.bfloat16)}},
        "opt": {"m": {"a": np.zeros((64,), np.float32)},
                "step": np.asarray(np.int32(7 + seed))},
        "layers": [rng.standard_normal((8,)).astype(np.float32) for _ in range(3)],
    }


def small_state(seed=0, scale=1.0):
    return tser.tree_from_numpy(small_state_np(seed, scale), "cpu")


def small_mgr():
    return TMgr(TStore(TConfig(**CFG), device="cpu"), device="cpu",
                shard_bytes=4096)


def assert_state_equal(a, b):
    fa, fb = flatten_with_path(a), flatten_with_path(b)
    assert [p for p, _ in fa] == [p for p, _ in fb]
    for (_p, x), (_q, y) in zip(fa, fb):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_paths_equal_jax_keystr():
    state = small_state_np()
    want = [jax.tree_util.keystr(p)
            for p, _ in jax.tree_util.tree_flatten_with_path(state)[0]]
    assert [p for p, _ in flatten_with_path(state)] == want
    assert "['layers'][0]" in want and "['opt']['step']" in want


def test_save_restore_roundtrip():
    mgr = small_mgr()
    state = small_state()
    mgr.save(10, state)
    step, got = mgr.restore(state)
    assert step == 10
    assert_state_equal(state, got)


def test_second_checkpoint_supersedes():
    mgr = small_mgr()
    s1, s2 = small_state(1), small_state(2, scale=2.0)
    mgr.save(10, s1)
    mgr.save(20, s2)
    step, got = mgr.restore(s1)
    assert step == 20
    assert_state_equal(s2, got)


def test_writer_crash_before_commit_keeps_previous():
    mgr = small_mgr()
    s1, s2 = small_state(1), small_state(2, scale=3.0)
    mgr.save(10, s1)
    with pytest.raises(RuntimeError, match="injected"):
        mgr.save(20, s2, fail_after_shards=2)
    step, got = mgr.restore(s1)
    assert step == 10
    assert_state_equal(s1, got)
    mgr.save(30, s2)
    step, got = mgr.restore(s1)
    assert step == 30
    assert_state_equal(s2, got)


def test_torn_manifest_falls_back_to_old_version():
    mgr = small_mgr()
    s1, s2 = small_state(1), small_state(2, scale=4.0)
    mgr.save(10, s1)
    assert mgr.save(20, s2) > 0
    mgr.store.dev.fault.arm(countdown=0, fraction=0.4)
    with pytest.raises(TornWrite):
        mgr.store.write(0x3A5F00D, json.dumps({"step": 99, "entries": []}).encode())
    step, got = mgr.restore(s1)
    assert step == 20
    assert_state_equal(s2, got)


def test_server_crash_recovery_then_restore():
    mgr = small_mgr()
    s1 = small_state(1)
    mgr.save(10, s1)
    assert mgr.crash_recover()["removed"] == 0
    step, got = mgr.restore(s1)
    assert step == 10
    assert_state_equal(s1, got)


def test_straggler_never_blocks_readers():
    mgr = small_mgr()
    s1, s2 = small_state(1), small_state(2, scale=5.0)
    mgr.save(10, s1)
    with pytest.raises(RuntimeError):
        mgr.save(20, s2, fail_after_shards=4)
    for _ in range(5):
        step, got = mgr.restore(s1)
        assert step == 10
        assert_state_equal(s1, got)


def port_store_on(server):
    """A port store whose client connects to ``server`` (either package's)."""
    s = object.__new__(TStore)
    s.server, s.dev = server, server.dev
    s.client = TClient(server, device="cpu")
    return s


def ref_store_on(server):
    s = object.__new__(RStore)
    s.server, s.dev = server, server.dev
    s.client = RClient(server)
    return s


def test_same_saves_leave_identical_nvm_and_cross_restore():
    rmgr = RMgr(RStore(RConfig(**CFG)), shard_bytes=4096)
    tmgr = small_mgr()
    for step, seed in ((10, 1), (20, 2)):
        rmgr.save(step, jax.tree.map(jnp.asarray, small_state_np(seed)))
        tmgr.save(step, small_state(seed))
    assert np.array_equal(rmgr.store.dev.mem, tmgr.store.dev.mem)
    assert vars(rmgr.store.dev.stats) == vars(tmgr.store.dev.stats)

    # the port restores what the reference saved, and the reverse
    step, got = TMgr(port_store_on(rmgr.store.server), device="cpu",
                     shard_bytes=4096).restore(small_state(0))
    assert step == 20
    assert_state_equal(small_state(2), got)
    step, got = RMgr(ref_store_on(tmgr.store.server), shard_bytes=4096) \
        .restore(small_state_np(0))
    assert step == 20
    for (p, x), (_q, y) in zip(jax.tree_util.tree_flatten_with_path(got)[0],
                               flatten_with_path(small_state_np(2))):
        assert np.asarray(x).dtype == y.dtype, p
        np.testing.assert_array_equal(np.asarray(x), y)


def test_restore_is_one_batch_same_nvm_fewer_doorbells():
    """The port fetches a manifest's shards with one multi_read (one batch
    CRC verify); the reference reads them one by one.  Same values, same NVM
    bytes and device counters — only the doorbell count differs."""
    rmgr = RMgr(RStore(RConfig(**CFG)), shard_bytes=4096)
    tmgr = small_mgr()
    rmgr.save(10, small_state_np(3))
    tmgr.save(10, small_state(3))
    r0, t0 = rmgr.store.transport.doorbells, tmgr.store.transport.doorbells
    rmgr.restore(small_state_np(0))
    tmgr.restore(small_state(0))
    r_bells = rmgr.store.transport.doorbells - r0
    t_bells = tmgr.store.transport.doorbells - t0
    assert np.array_equal(rmgr.store.dev.mem, tmgr.store.dev.mem)
    assert vars(rmgr.store.dev.stats) == vars(tmgr.store.dev.stats)
    assert t_bells < r_bells
    assert t_bells == 2  # the manifest read + one doorbell for every shard
