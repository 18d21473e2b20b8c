"""Serving entry point: batched greedy decode with Erda-backed state snapshots —
the port of ``repro/launch/serve.py``.

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --device cuda --scale full

Weights are random, drawn from seed 0.  The page store is sized so that one
segment holds a whole decode-cache leaf (``serving.page_shard_config``).
"""
from __future__ import annotations

import argparse

import torch

from repro_torch._device import resolve_device
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import make_store
from repro_torch.data import make_batch
from repro_torch.launch.train import scale_config
from repro_torch.models import get_model
from repro_torch.models.layers.basic import dtype_of
from repro_torch.models.transformer import CACHE_PAD
from repro_torch.serving import ErdaKVPageStore, ServeEngine, page_shard_config


def page_store_for(cfg, batch: int, prompt_len: int, tokens: int,
                   snapshot_every: int, device) -> ErdaKVPageStore:
    """A 2-shard page store whose segments hold one cache leaf, with room for
    every snapshot a run of ``tokens`` tokens writes (one more after a
    recovery): four cache leaves and the tokens page each."""
    itemsize = torch.tensor([], dtype=dtype_of(cfg)).element_size()
    leaf = (cfg.n_layers * batch * (prompt_len + CACHE_PAD) * cfg.n_kv_heads
            * cfg.head_dim * itemsize)
    versions = (tokens // snapshot_every + 2) if snapshot_every else 0
    cfg_shard = page_shard_config(leaf, 5 * versions)
    return ErdaKVPageStore(make_store("erda-cluster", n_shards=2, cfg=cfg_shard,
                                      device=device), device=device)


def serve(arch="olmo_1b", scale="smoke", batch=4, prompt_len=64, tokens=16,
          snapshot_every=8, crash_at=None, device="cuda"):
    dev = resolve_device(device)
    cfg = scale_config(get_config(arch), scale)
    model = get_model(cfg, dev)
    params = model.init(0)
    pages = page_store_for(cfg, batch, prompt_len, tokens, snapshot_every, dev)
    engine = ServeEngine(model, params, page_store=pages,
                         snapshot_every=snapshot_every, device=dev)
    shape = ShapeConfig("serve", prompt_len, batch, "prefill")
    b = {k: torch.as_tensor(v, device=dev) for k, v in make_batch(cfg, shape).items()}
    return engine.generate(b, tokens, crash_at=crash_at)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo_1b")
    ap.add_argument("--scale", default="smoke", choices=["smoke", "100m", "full"])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args()
    out = serve(args.arch, args.scale, args.batch, args.prompt_len, args.tokens,
                device=args.device)
    print(f"[serve] generated {out.shape[1]} tokens × {out.shape[0]} requests")
    print(out[:, :12])


if __name__ == "__main__":
    main()
