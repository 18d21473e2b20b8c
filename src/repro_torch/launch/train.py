"""End-to-end training launcher with Erda checkpointing + restart — the port
of ``repro/launch/train.py``.

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --device cuda --scale full \
        --batch 4 --seq 2048 --steps 5

Weights are random, drawn from seed 0.  A checkpoint holds the train state
with the reference's leaf paths (``models.convert.to_reference_tree``), so
either package resumes what the other saved.  Without ``ckpt_mgr`` the
launcher makes a manager whose store holds the run's checkpoints
(``checkpoint_manager_for``): olmo_1b's full train state (11.8 GB of
parameters and AdamW moments) does not fit the default manager's 1 GiB.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, Optional, Tuple

import torch

from repro_torch._device import resolve_device
from repro_torch.checkpoint import ErdaCheckpointManager
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import ServerConfig, make_store
from repro_torch.data import make_batch
from repro_torch.models import get_model
from repro_torch.models.convert import from_reference_tree, to_reference_tree
from repro_torch.optim import AdamWConfig, cosine_schedule
from repro_torch.train import make_train_step
from repro_torch.train.step import make_train_state, make_train_state_abstract
from repro_torch.tree import flatten_with_path, map_leaves

#: NVM of each server of the checkpoint store: under 2 GiB, since a
#: hash-table word holds 31-bit log offsets
CKPT_SERVER_NVM = 1536 << 20
#: the manager's shard size; a segment holds two shard records
SHARD_BYTES = 4 << 20


def scale_config(cfg, scale: str):
    if scale == "full":
        return cfg
    if scale == "smoke":
        return cfg.scaled_down()
    if scale == "100m":  # ~100M params, runnable on CPU for a few hundred steps
        return dataclasses.replace(
            cfg, n_layers=6, d_model=512, n_heads=8, n_kv_heads=8, head_dim=64,
            d_ff=2048, vocab_size=8192, window=min(cfg.window, 256) if cfg.window else 0,
            n_experts=min(cfg.n_experts, 8), n_experts_active=min(cfg.n_experts_active, 2),
            encoder_seq=min(cfg.encoder_seq, 64) if cfg.encoder_seq else 0,
            n_patches=min(cfg.n_patches, 16) if cfg.n_patches else 0,
            attn_chunk=256, remat="none",
            tie_embeddings=False)  # untied head learns faster from small init
    raise ValueError(scale)


def nbytes(tree) -> int:
    """Bytes of a tensor tree's leaves (meta tensors included)."""
    return sum(t.numel() * t.element_size() for _p, t in flatten_with_path(tree))


def checkpoint_manager_for(state_bytes: int, saves: int = 1,
                           device="cuda") -> ErdaCheckpointManager:
    """A checkpoint manager whose NVM holds ``saves`` checkpoints of a
    ``state_bytes`` state twice over: an erda-cluster of as many
    ``CKPT_SERVER_NVM`` servers as that takes (one for a small state; the
    NVM is allocated lazily).  The slack covers the hash ring, which loads
    its busiest server up to ~1.4x the mean, and the log's segment tails."""
    dev = resolve_device(device)
    need = 2 * saves * state_bytes
    seg = 2 * SHARD_BYTES + (64 << 10)
    cfg = ServerConfig(device_size=CKPT_SERVER_NVM, table_capacity=1 << 15,
                       n_heads=4, region_size=2 * seg, segment_size=seg)
    store = make_store("erda-cluster", n_shards=-(-need // CKPT_SERVER_NVM),
                       cfg=cfg, device=dev)
    return ErdaCheckpointManager(store, device=dev, shard_bytes=SHARD_BYTES)


def trainer_step(model, lr: float, steps: int):
    """The launcher's step: AdamW(lr) under a cosine schedule with 20 warm-up
    steps over max(steps, 100)."""
    return make_train_step(
        model, AdamWConfig(lr=lr),
        schedule=lambda s: cosine_schedule(s, warmup=20, total=max(steps, 100)))


def batch_at(cfg, seq: int, batch: int, step: int, device) -> Dict[str, torch.Tensor]:
    """The synthetic batch of ``step`` on ``device``."""
    shape = ShapeConfig("drv", seq, batch, "train")
    return {k: torch.as_tensor(v, device=device)
            for k, v in make_batch(cfg, shape, step=step).items()}


def save_train_state(mgr: ErdaCheckpointManager, step: int, state, **kwargs) -> int:
    """``mgr.save`` of the state in the reference's tree; returns the shards
    written."""
    return mgr.save(step, to_reference_tree(state), **kwargs)


def restore_train_state(mgr: ErdaCheckpointManager,
                        model) -> Tuple[Optional[int], Optional[Dict]]:
    """(step, state on the model's device) of the newest committed
    checkpoint, or (None, None).  The template is the state's meta-device
    tree, so nothing is allocated before the restore."""
    template = to_reference_tree(make_train_state_abstract(model))
    step, got = mgr.restore(template)
    if step is None:
        return None, None
    return step, from_reference_tree(map_leaves(lambda t: t.to(model.device), got))


def train(arch="olmo_1b", scale="smoke", steps=50, batch=8, seq=128,
          ckpt_every=0, resume=False, ckpt_mgr=None, lr=3e-4, log_every=10,
          fail_ckpt_at=None, device="cuda"):
    dev = resolve_device(device)
    cfg = scale_config(get_config(arch), scale)
    model = get_model(cfg, dev)
    step_fn = trainer_step(model, lr, steps)
    saves = max(1, steps // ckpt_every if ckpt_every else 0)
    mgr = ckpt_mgr or checkpoint_manager_for(
        nbytes(make_train_state_abstract(model)), saves, dev)
    start = 0
    state = None
    if resume:
        got_step, got = restore_train_state(mgr, model)
        if got_step is not None:
            start, state = got_step, got
            print(f"[train] resumed from Erda checkpoint @ step {start}")
    if state is None:
        state = make_train_state(model, 0)

    losses = []
    t0 = time.time()
    for s in range(start, steps):
        state, metrics = step_fn(state, batch_at(cfg, seq, batch, s, dev))
        losses.append(float(metrics["loss"]))
        if log_every and (s + 1) % log_every == 0:
            print(f"[train] step {s+1}: loss {losses[-1]:.4f} "
                  f"({(time.time()-t0)/max(1,s+1-start):.2f}s/step)")
        if ckpt_every and (s + 1) % ckpt_every == 0:
            kwargs = {}
            if fail_ckpt_at is not None and (s + 1) == fail_ckpt_at:
                kwargs["fail_after_shards"] = 3
            try:
                save_train_state(mgr, s + 1, state, **kwargs)
            except RuntimeError as e:
                if not kwargs:
                    raise
                print(f"[train] checkpoint writer crashed @ step {s+1}: {e}")
    return state, losses, mgr


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo_1b")
    ap.add_argument("--scale", default="smoke", choices=["smoke", "100m", "full"])
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args()
    _, losses, _ = train(args.arch, args.scale, args.steps, args.batch,
                         args.seq, args.ckpt_every, args.resume, lr=args.lr,
                         device=args.device)
    print(f"[train] done: first loss {losses[0]:.4f} → last {losses[-1]:.4f}")


if __name__ == "__main__":
    main()
