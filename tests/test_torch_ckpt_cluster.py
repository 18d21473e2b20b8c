"""The checkpoint manager on the store ``launch.train.checkpoint_manager_for``
builds (an erda-cluster of servers sized for the state), against the reference's
manager on its single ``ErdaStore``: a torn manifest falls back to the
previous manifest version, a committed step that lost a shard falls back to
the previous committed step, and ``crash_recover()`` runs the §4.2 scan on
every server and returns its stats.  The port's single store keeps working
the same way."""
import json

import numpy as np
import pytest
import torch

from repro.checkpoint import ErdaCheckpointManager as RMgr
from repro.core import ErdaStore as RStore
from repro.core import ServerConfig as RConfig
from repro_torch.checkpoint import ErdaCheckpointManager as TMgr
from repro_torch.checkpoint import serialization as tser
from repro_torch.checkpoint.erda_ckpt import MANIFEST_KEY, _leaf_key
from repro_torch.core import ErdaClusterStore
from repro_torch.core import ErdaStore as TStore
from repro_torch.core import ServerConfig as TConfig
from repro_torch.launch import train as T
from repro_torch.nvmsim.device import TornWrite
from repro_torch.tree import flatten_with_path

#: small log regions: the §4.2 scan steps through a region's free bytes
#: 8 at a time in Python, so its time grows with the regions' size
CFG = dict(device_size=8 << 20, table_capacity=1 << 12, n_heads=2,
           region_size=1 << 20, segment_size=256 << 10)
#: the launcher's sizing at a small scale: 4 MiB servers and 16 KiB shards
#: (its own, 1.5 GiB and 4 MiB, give each server a 64 MiB log that one
#: recovery scan walks in about 30 s on the CPU)
SERVER_NVM, SHARD_BYTES = 4 << 20, 16 << 10
#: state bytes for which ``checkpoint_manager_for`` (one save) builds 2 and
#: 3 servers
CLUSTER_STATE = {2: 4 << 20, 3: 6 << 20}


@pytest.fixture(autouse=True)
def small_servers(monkeypatch):
    monkeypatch.setattr(T, "CKPT_SERVER_NVM", SERVER_NVM)
    monkeypatch.setattr(T, "SHARD_BYTES", SHARD_BYTES)


def state_np(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"params": {"w": (rng.standard_normal((64, 96)) * scale).astype(np.float32),
                       "b": rng.standard_normal((96,)).astype(np.float32)},
            "layers": [rng.standard_normal((16,)).astype(np.float32) for _ in range(3)],
            "step": np.asarray(np.int32(seed))}


def state(seed, scale=1.0):
    return tser.tree_from_numpy(state_np(seed, scale), "cpu")


def make_mgr(kind):
    """``"single"``: the port's manager on one ``ErdaStore``; an int n: the
    launcher's manager, a cluster of n servers."""
    if kind == "single":
        return TMgr(TStore(TConfig(**CFG), device="cpu"), device="cpu")
    mgr = T.checkpoint_manager_for(CLUSTER_STATE[kind], saves=1, device="cpu")
    assert isinstance(mgr.store, ErdaClusterStore) and len(mgr.store.devs) == kind
    return mgr


def manifest_dev(mgr):
    """The NVM device of the server that holds the manifest."""
    if kind_of(mgr) == "single":
        return mgr.store.dev
    shard = mgr.store.shard_for_key(MANIFEST_KEY)
    return mgr.store.cluster.groups[shard].primary.server.dev


def kind_of(mgr):
    return "single" if isinstance(mgr.store, TStore) else len(mgr.store.devs)


def assert_state_equal(want, got):
    fa, fb = flatten_with_path(want), flatten_with_path(got)
    assert [p for p, _ in fa] == [p for p, _ in fb]
    for (p, a), (_q, b) in zip(fa, fb):
        assert a.dtype == b.dtype and torch.equal(a, b), p


def ref_mgr():
    return RMgr(RStore(RConfig(**CFG)))


KINDS = ["single", 2, 3]


@pytest.mark.parametrize("kind", KINDS)
def test_torn_manifest_falls_back_to_old_version(kind):
    """``tests/test_checkpoint.py``'s torn-manifest case on the port's
    stores; the reference on its single store restores the same step."""
    mgr = make_mgr(kind)
    s1, s2 = state(1), state(2, scale=4.0)
    mgr.save(10, s1)
    assert mgr.save(20, s2) > 0
    manifest_dev(mgr).fault.arm(countdown=0, fraction=0.4)
    with pytest.raises(TornWrite):
        mgr.store.write(MANIFEST_KEY, json.dumps({"step": 99, "entries": []}).encode())
    step, got = mgr.restore(s1)
    assert step == 20
    assert_state_equal(s2, got)

    rm = ref_mgr()
    rm.save(10, state_np(1))
    rm.save(20, state_np(2, scale=4.0))
    rm.store.dev.fault.arm(countdown=0, fraction=0.4)
    from repro.nvmsim.device import TornWrite as RTornWrite
    with pytest.raises(RTornWrite):
        rm.store.write(MANIFEST_KEY, json.dumps({"step": 99, "entries": []}).encode())
    assert rm.restore(state_np(1))[0] == step


@pytest.mark.parametrize("kind", KINDS)
def test_server_crash_recovery_then_restore(kind):
    """``crash_recover()`` returns the scan's stats (summed over every
    shard of a cluster) and the committed step still restores."""
    mgr = make_mgr(kind)
    s1 = state(1)
    mgr.save(10, s1)
    stats = mgr.crash_recover()
    assert stats["removed"] == 0
    if kind != "single":
        assert stats["shards"] == kind
    step, got = mgr.restore(s1)
    assert step == 10
    assert_state_equal(s1, got)

    rm = ref_mgr()
    rm.save(10, state_np(1))
    assert rm.crash_recover()["removed"] == stats["removed"]


@pytest.mark.parametrize("kind", KINDS)
def test_missing_shard_falls_back_to_previous_step(kind):
    """A committed step that lost a shard restores the previous committed
    step from the manifest's old version, on the shard that owns it; the
    reference on its single store does the same."""
    mgr = make_mgr(kind)
    s1, s2 = state(1), state(2, scale=3.0)
    mgr.save(10, s1)
    mgr.save(20, s2)
    lost = _leaf_key(mgr.tag, 20, "['params']['w']", 0)
    mgr.store.delete(lost)
    assert mgr.store.read(lost) is None
    step, got = mgr.restore(s1)
    assert step == 10
    assert_state_equal(s1, got)

    rm = ref_mgr()
    rm.save(10, state_np(1))
    rm.save(20, state_np(2, scale=3.0))
    rm.store.delete(_leaf_key(rm.tag, 20, "['params']['w']", 0))
    rstep, rgot = rm.restore(state_np(1))
    assert rstep == step
    np.testing.assert_array_equal(rgot["params"]["w"], state_np(1)["params"]["w"])


@pytest.mark.parametrize("kind", [2, 3])
def test_torn_manifest_then_crash_recovery_on_the_cluster(kind):
    """A torn manifest, then a restart of every server (the §4.2 sweep
    repairs the manifest's word back to its old version), then a lost shard
    of the newest step: each restore lands on the newest consistent step."""
    mgr = make_mgr(kind)
    s1, s2 = state(1), state(2, scale=2.0)
    mgr.save(10, s1)
    mgr.save(20, s2)
    manifest_dev(mgr).fault.arm(countdown=0, fraction=0.5)
    with pytest.raises(TornWrite):
        mgr.store.write(MANIFEST_KEY, json.dumps({"step": 99, "entries": []}).encode())
    stats = mgr.crash_recover()
    assert stats["shards"] == kind
    step, got = mgr.restore(s1)
    assert step == 20
    assert_state_equal(s2, got)
    mgr.save(30, s1)
    mgr.store.delete(_leaf_key(mgr.tag, 30, "['layers'][2]", 0))
    step, got = mgr.restore(s1)
    assert step == 20
    assert_state_equal(s2, got)


def test_launcher_train_resume_after_recovery_on_the_cluster():
    """The launcher's own manager (olmo_1b's scaled-down train state on
    4 MiB servers, several of them): checkpoint, restart every server, resume;
    the resumed losses equal the uninterrupted ones (the reference's bound,
    rel 1e-4)."""
    _s, losses_a, mgr = T.train(arch="olmo_1b", scale="smoke", steps=6, batch=2,
                                seq=32, ckpt_every=4, log_every=0, device="cpu")
    assert isinstance(mgr.store, ErdaClusterStore) and len(mgr.store.devs) >= 2
    stats = mgr.crash_recover()
    assert stats["removed"] == 0 and stats["shards"] == len(mgr.store.devs)
    _s, losses_b, _m = T.train(arch="olmo_1b", scale="smoke", steps=6, batch=2,
                               seq=32, resume=True, ckpt_mgr=mgr, log_every=0,
                               device="cpu")
    assert losses_b == pytest.approx(losses_a[-2:], rel=1e-4)
