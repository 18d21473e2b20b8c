"""Model registry: the reference's functional interface for every family
(``repro/models/registry.py``).

get_model(cfg, device) -> namespace with:
  init(key=0, max_seq=4096)            — parameters; key is a seed or a
                                         ``torch.Generator`` on ``device``;
                                         ``max_seq`` sizes encdec's decoder
                                         positions and nothing else
  init_abstract(max_seq=4096)          — the parameters' tree, shapes and
                                         dtypes on the meta device (no storage)
  train_loss(params, batch)            — scalar loss
  prefill(params, batch)               — (last_logits, cache)
  decode_step(params, cache, token)
  init_cache(batch_size, seq_len)      — empty cache on ``device``
  input_specs(shape)                   — meta-device stand-ins for every
                                         input of ``shape``'s step kind
``family_module`` routes a config as the reference's ``_family_module``
does: the transformer serves the dense, moe and vlm families,
``rwkv_model`` the ssm family, ``hybrid`` and ``encdec`` theirs; the
transformer also serves hybrid_moe (granite 4.0-H: a Mamba2 or attention
mixer a layer, each followed by the MoE), which the reference lacks.
"""
from __future__ import annotations

import functools
from types import SimpleNamespace

import torch

from repro_torch._device import resolve_device
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import encdec, hybrid, rwkv_model, transformer


def family_module(cfg: ModelConfig):
    if cfg.family in transformer.FAMILIES:
        return transformer
    if cfg.family == "encdec":
        return encdec
    if cfg.family == "hybrid":
        return hybrid
    if cfg.family == "ssm":
        return rwkv_model
    raise ValueError(f"unknown family {cfg.family}")


def get_model(cfg: ModelConfig, device="cuda") -> SimpleNamespace:
    mod = family_module(cfg)
    dev = resolve_device(device)

    def build(gen, max_seq):
        if cfg.family == "encdec":
            return mod.init_lm(cfg, gen, max_seq)
        return mod.init_lm(cfg, gen)

    def init(key=0, max_seq: int = 4096):
        gen = key if isinstance(key, torch.Generator) \
            else torch.Generator(device=dev).manual_seed(int(key))
        if gen.device.type != dev.type:
            raise ValueError(f"generator on {gen.device}, model on {dev}")
        with torch.device(dev):
            return build(gen, max_seq)

    def init_abstract(max_seq: int = 4096):
        with torch.device("meta"):
            return build(torch.Generator(), max_seq)

    def input_specs(shape: ShapeConfig):
        """The reference's ``input_specs``: meta tensors (shapes and dtypes,
        no storage) for a train or prefill batch — tokens, plus encdec's
        frames or vlm's patches in the config's dtype — or, for decode, one
        token and a cache holding ``seq_len`` of history."""
        meta = torch.device("meta")
        B, S = shape.global_batch, shape.seq_len
        tok = torch.empty((B, S), dtype=torch.int32, device=meta)
        dt = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
        if shape.kind in ("train", "prefill"):
            batch = {"tokens": tok}
            if cfg.family == "encdec":
                batch["frames"] = torch.empty((B, cfg.encoder_seq, cfg.d_model),
                                              dtype=dt, device=meta)
            if cfg.family == "vlm":
                batch["patches"] = torch.empty((B, cfg.n_patches, cfg.d_model),
                                               dtype=dt, device=meta)
            return batch
        # decode: one token + a cache holding seq_len of history
        return {"token": torch.empty((B, 1), dtype=torch.int32, device=meta),
                "cache": mod.init_cache(cfg, B, S, device=meta)}

    return SimpleNamespace(
        cfg=cfg,
        device=dev,
        init=init,
        init_abstract=init_abstract,
        train_loss=functools.partial(mod.train_loss, cfg),
        prefill=functools.partial(mod.prefill, cfg),
        decode_step=functools.partial(mod.decode_step, cfg),
        init_cache=functools.partial(mod.init_cache, cfg, device=dev),
        input_specs=input_specs,
    )
