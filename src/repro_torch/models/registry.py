"""Model registry: the reference's functional interface for the families the
port has (``repro/models/registry.py``).

get_model(cfg, device) -> namespace with:
  init(key=0)                          — parameters; key is a seed or a
                                         ``torch.Generator`` on ``device``
  init_abstract()                      — the parameters' tree, shapes and
                                         dtypes on the meta device (no storage)
  train_loss(params, batch)            — scalar loss
  prefill(params, batch)               — (last_logits, cache)
  decode_step(params, cache, token)
  init_cache(batch_size, seq_len)      — empty cache on ``device``
The transformer serves the dense, moe and vlm families, as the reference's
``_family_module`` routes them; the other families (ssm, hybrid, encdec)
raise ``NotImplementedError``.
"""
from __future__ import annotations

import functools
from types import SimpleNamespace

import torch

from repro_torch._device import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer


def get_model(cfg: ModelConfig, device="cuda") -> SimpleNamespace:
    transformer.check_supported(cfg)
    dev = resolve_device(device)

    def init(key=0):
        gen = key if isinstance(key, torch.Generator) \
            else torch.Generator(device=dev).manual_seed(int(key))
        if gen.device.type != dev.type:
            raise ValueError(f"generator on {gen.device}, model on {dev}")
        with torch.device(dev):
            return transformer.init_lm(cfg, gen)

    def init_abstract():
        with torch.device("meta"):
            return transformer.init_lm(cfg, torch.Generator())

    return SimpleNamespace(
        cfg=cfg,
        device=dev,
        init=init,
        init_abstract=init_abstract,
        train_loss=functools.partial(transformer.train_loss, cfg),
        prefill=functools.partial(transformer.prefill, cfg),
        decode_step=functools.partial(transformer.decode_step, cfg),
        init_cache=functools.partial(transformer.init_cache, cfg, device=dev),
    )
