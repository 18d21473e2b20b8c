"""Elastic scaling + straggler policy — the port of ``repro/launch/elastic.py``.

Erda checkpoints are stored shape-canonical (full logical arrays, sharded into
fixed-size log objects), so restoring onto a DIFFERENT mesh is a restore
followed by a distribute with the new mesh's placements — ``reshard_restore``.
Every shard the restore reads is CRC-verified by the manager's client (on a
CUDA device, by the CRC kernel).  Straggler policy is inherited from the
protocol itself: a writer that never commits simply never flips the manifest
word; readers keep the previous version (no barrier, no timeout coordination).
"""
from __future__ import annotations

from repro_torch.checkpoint import ErdaCheckpointManager
from repro_torch.models.convert import from_reference_tree
from repro_torch.sharding import MeshInfo, distribute_tree, param_specs
from repro_torch.tree import map_leaves


def reshard_restore(mgr: ErdaCheckpointManager, template, mesh, n_experts=0):
    """Restore the newest consistent checkpoint onto `mesh` (any size):
    (step, {"params", "opt": {"m", "v", "step"}}) with the parameters and
    moments DTensors placed by ``param_specs`` and ``step`` a plain tensor,
    or (None, None) when the store holds no checkpoint.  ``template`` is
    the train state in the reference's tree (``models.convert.
    to_reference_tree``; meta tensors allocate nothing), as
    ``launch.train.restore_train_state`` passes it; the state comes back
    in the port's per-layer tree, on the mesh's device."""
    step, state = mgr.restore(template)
    if step is None:
        return None, None
    dev = mesh.device_type
    state = from_reference_tree(map_leaves(lambda t: t.to(dev), state))
    pspec = param_specs(state["params"], MeshInfo(mesh), n_experts)
    opt = state["opt"]
    return step, {"params": distribute_tree(state["params"], pspec, mesh),
                  "opt": {"m": distribute_tree(opt["m"], pspec, mesh),
                          "v": distribute_tree(opt["v"], pspec, mesh),
                          "step": opt["step"].to(dev)}}
