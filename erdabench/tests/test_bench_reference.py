"""The plain reference computes what the program computes, where both run
in float32 on the CPU at test size: prefill and decode-through-the-cache
logits (dense and MoE, the MoE's capacity drops included), the AdamW step,
and the CRC.  The reference itself imports nothing of the program; this
test holds the two side by side."""
import dataclasses

import numpy as np
import pytest
import torch

from erdabench import weights
from erdabench.reference import adamw as ref_adamw
from erdabench.reference import model as ref_model
from erdabench.reference.pages import zlib_rows
from erdabench.serve import leaves

from conftest import GRANITE_TINY, OLMO_TINY

CPU = torch.device("cpu")


@pytest.mark.parametrize("m", [OLMO_TINY, dict(GRANITE_TINY, capacity_factor=0.5)],
                         ids=["dense", "moe_with_drops"])
def test_served_logits_match_the_program(m):
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models import get_model
    m = dict(m, dtype="float32")
    model = get_model(ModelConfig(**m), CPU)
    params = weights.make_params(m, 3, CPU)
    prompts = weights.token_stream(3, m["vocab_size"], CPU)(2, 32)
    with torch.no_grad():
        logits, cache = model.prefill(params, {"tokens": prompts})
        got, served = [logits[:, 0]], [logits.argmax(-1)]
        for _ in range(5):
            logits, cache = model.decode_step(params, cache, served[-1].to(torch.int32))
            got.append(logits[:, 0])
            served.append(logits.argmax(-1))
    got = torch.stack(got, 1)                                 # (B, n, V)
    served = torch.cat(served, 1)
    want = torch.stack(ref_model.served_logits(ref_model.Reference(m), params,
                                               prompts, served), 0)
    assert torch.allclose(got, want, atol=2e-5, rtol=2e-5), (got - want).abs().max()


def test_adamw_matches_the_program():
    from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
    g = torch.Generator().manual_seed(0)
    params = {"a": torch.randn(5, 7, generator=g), "b": torch.randn(3, generator=g)}
    cfg = AdamWConfig(lr=1e-2)
    opt = adamw_init(params)
    ps = [p.clone() for _k, p in leaves(params)]
    m = [torch.zeros_like(p) for p in ps]
    v = [torch.zeros_like(p) for p in ps]
    hp = dataclasses.asdict(cfg)
    for step in range(1, 4):
        grads = {"a": 3 * torch.randn(5, 7, generator=g), "b": torch.randn(3, generator=g)}
        params, opt, _ = adamw_update(cfg, params, grads, opt)
        ref_adamw.adamw_step(hp, ps, [t for _k, t in leaves(grads)], m, v, step)
        for (_k, p), q in zip(leaves(params), ps):
            assert torch.allclose(p, q, atol=1e-6, rtol=1e-6)


def test_zlib_rows_match_the_program_crc():
    from repro_torch.kernels import ops
    words = torch.from_numpy(np.random.default_rng(0).integers(
        -2**31, 2**31, (4, 33), dtype=np.int64).astype(np.int32))
    assert zlib_rows(words) == [int(x) for x in ops.crc32_batch(words)]
