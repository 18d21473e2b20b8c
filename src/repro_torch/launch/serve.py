"""Serving entry point: batched greedy decode with Erda-backed state snapshots —
the port of ``repro/launch/serve.py``.

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --device cuda --scale full

    PYTHONPATH=src python -m repro_torch.launch.serve --device cuda --scale full \
        --arch gemma3_27b --batch 1 --prompt-len 1536
    PYTHONPATH=src python -m repro_torch.launch.serve --device cuda --scale full \
        --arch granite_moe_3b --prompt-len 1024
    PYTHONPATH=src python -m repro_torch.launch.serve --device cuda --scale full \
        --arch gemma3_12b --batch 1 --prompt-len 1536
    PYTHONPATH=src python -m repro_torch.launch.serve --device cuda --scale full \
        --arch rwkv6_1p6b --prompt-len 1024
    PYTHONPATH=src python -m repro_torch.launch.serve --device cuda --scale full \
        --arch zamba2_1p2b --prompt-len 1024
    PYTHONPATH=src python -m repro_torch.launch.serve --device cuda --scale full \
        --arch whisper_small

Weights are random, drawn from seed 0.  Every family of the repository's
configs serves (``--arch``, any of ``configs.ARCH_IDS``): the transformer's
dense, moe (granite_moe_3b, mixtral_8x22b) and vlm (pixtral_12b) families
with the full, swa and local_global patterns; ssm (rwkv6_1p6b), hybrid
(zamba2_1p2b) and encdec (whisper_small, whose prompts carry the stub
frontend's ``frames``, 1500 of them at the full config).  The page store
is sized from the decode cache's leaves (``page_store_for``): a segment
holds the largest, and each shard every snapshot of the run, under its
31-bit offsets.
"""
from __future__ import annotations

import argparse
import dataclasses

import torch

from repro_torch._device import resolve_device
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import make_store
from repro_torch.data import make_batch
from repro_torch.launch.train import scale_config
from repro_torch.models import get_model
from repro_torch.models.registry import family_module
from repro_torch.serving import ErdaKVPageStore, ServeEngine, page_shard_config
from repro_torch.tree import flatten_with_path


def snapshot_pages(cfg, batch: int, prompt_len: int, tokens: int):
    """(name, bytes) of every page a snapshot of a ``batch`` x
    ``prompt_len`` run writes, in order: the decode cache's leaves, from
    the config's family's ``init_cache`` tree on the meta device, then the
    tokens page.  Prefill caches carry no int8 scales, so the tree is made
    without ``cache_quant``; a vlm prompt also holds the patch
    embeddings."""
    seq = prompt_len + (cfg.n_patches if cfg.family == "vlm" else 0)
    tree = family_module(cfg).init_cache(dataclasses.replace(cfg, cache_quant=False),
                                         batch, seq, device="meta")
    return [(path, leaf.numel() * leaf.element_size())
            for path, leaf in flatten_with_path(tree)] + [("__tokens__", 4 * batch * tokens)]


def page_store_for(cfg, batch: int, prompt_len: int, tokens: int,
                   snapshot_every: int, device) -> ErdaKVPageStore:
    """A 2-shard page store for one run of ``serve``'s engine, sized from
    the cache's own leaves (``serving.page_shard_config``): each shard holds
    every snapshot a run of ``tokens`` tokens writes, ceil((tokens - 1) /
    snapshot_every), and one more after a recovery."""
    versions = -(-(tokens - 1) // snapshot_every) + 1 if snapshot_every else 1
    shard = page_shard_config(snapshot_pages(cfg, batch, prompt_len, tokens), versions)
    return ErdaKVPageStore(make_store("erda-cluster", n_shards=2, cfg=shard,
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
    ap.add_argument("--arch", default="olmo_1b", choices=ARCH_IDS)
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
