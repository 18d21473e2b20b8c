"""``repro_torch.launch.elastic.reshard_restore`` on a 2 × 2 (data, model)
mesh of four gloo processes: each process saves a train state with the JAX
package's ``ErdaCheckpointManager`` (in that process: the leaf keys hash a
``str``, which Python salts per process), the port restores it through its
own manager onto the mesh, and each rank's local shard of every parameter
and moment must equal the slice of the saved numpy array that the sharding
rules give it, and gathered back its whole array; an empty store gives
(None, None)."""
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

RANK = textwrap.dedent("""
    import dataclasses, os, sys
    import jax, jax.numpy as jnp
    import ml_dtypes
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Shard
    from repro.checkpoint import ErdaCheckpointManager as RMgr
    from repro.core import ErdaStore as RStore, ServerConfig as RConfig
    from repro_torch.checkpoint import ErdaCheckpointManager as TMgr
    from repro_torch.configs import get_config
    from repro_torch.core import ErdaStore as TStore, ServerConfig as TConfig
    from repro_torch.core.client import ErdaClient as TClient
    from repro_torch.launch.elastic import reshard_restore
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import get_model
    from repro_torch.models.convert import to_reference_tree, train_state_from_numpy
    from repro_torch.sharding import MeshInfo, param_specs, placements
    from repro_torch.train.step import make_train_state_abstract
    from repro_torch.tree import flatten_with_path, unflatten

    rank, world, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    CFG = dict(device_size=64 << 20, table_capacity=1 << 12, n_heads=2,
               region_size=4 << 20, segment_size=1 << 20)
    # narrow, so that the plain CRC (the CPU's verify) stays quick
    cfg = dataclasses.replace(get_config("olmo_1b").scaled_down(), n_layers=2, d_model=32,
                              n_heads=4, n_kv_heads=2, head_dim=8, d_ff=64, vocab_size=128)
    model = get_model(cfg, "cpu")
    template = to_reference_tree(make_train_state_abstract(model))

    # the saved state: the reference's tree, numpy leaves from seed 0
    rng = np.random.default_rng(0)
    def draw(t):
        dt = {torch.float32: np.float32, torch.bfloat16: ml_dtypes.bfloat16,
              torch.int32: np.int32}[t.dtype]
        if t.dtype == torch.int32:
            return np.asarray(rng.integers(0, 100, size=tuple(t.shape)), dt)
        return rng.standard_normal(tuple(t.shape)).astype(dt)
    saved = unflatten(template, [draw(t) for _p, t in flatten_with_path(template)])
    rmgr = RMgr(RStore(RConfig(**CFG)), shard_bytes=1 << 16)
    rmgr.save(7, jax.tree.map(jnp.asarray, saved))

    def port_mgr(server):
        s = object.__new__(TStore)
        s.server, s.dev = server, server.dev
        s.client = TClient(server, device="cpu")
        return TMgr(s, device="cpu", shard_bytes=1 << 16)

    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    mesh = make_test_mesh(data=2, model=2)
    step, state = reshard_restore(port_mgr(rmgr.store.server), template, mesh)
    assert step == 7
    want = train_state_from_numpy(saved, cfg, "cpu")
    coord = mesh.get_coordinate()
    specs = param_specs(want["params"], MeshInfo(mesh))
    n_sharded = 0
    for tree in ("params", "m", "v"):
        got_t = state["params"] if tree == "params" else state["opt"][tree]
        want_t = want["params"] if tree == "params" else want["opt"][tree]
        for (path, g), (_q, w), (_r, spec) in zip(
                flatten_with_path(got_t), flatten_with_path(want_t),
                flatten_with_path(specs, is_leaf=lambda x: isinstance(x, tuple))):
            assert isinstance(g, DTensor) and tuple(g.placements) == placements(spec, mesh)
            piece = w
            for mesh_dim, p in enumerate(g.placements):
                if isinstance(p, Shard):
                    piece = torch.chunk(piece, mesh.size(mesh_dim), p.dim)[coord[mesh_dim]]
                    n_sharded += 1
            local = g.to_local()
            assert local.dtype == piece.dtype and torch.equal(local, piece), (tree, path)
            if tree == "params":  # gathered over gloo, the whole array again
                assert torch.equal(g.full_tensor(), w), path
    assert n_sharded > 0
    assert not isinstance(state["opt"]["step"], DTensor)
    assert int(state["opt"]["step"]) == int(saved["opt"]["step"])
    empty = TMgr(TStore(TConfig(**CFG), device="cpu"), device="cpu", shard_bytes=1 << 16)
    assert reshard_restore(empty, template, mesh) == (None, None)
    dist.barrier()
    dist.destroy_process_group()
    print("ok", rank, n_sharded)
""")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_reshard_restore_on_a_2x2_gloo_mesh():
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]), JAX_PLATFORMS="cpu")
    port = str(free_port())
    procs = [subprocess.Popen([sys.executable, "-c", RANK, str(r), "4", port], cwd=ROOT,
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(4)]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=240)
        finally:
            p.kill()
        outs.append((p.returncode, out, err))
    for r, (rc, out, err) in enumerate(outs):
        assert rc == 0 and out.startswith(f"ok {r}"), out + err[-4000:]
