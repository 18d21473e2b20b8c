"""The port's hybrid_moe family (granite 4.0-H: ``models.transformer`` with
a Mamba2 or a NoPE attention mixer a layer, each followed by the MoE and
its shared expert, under µP's four scalars) against the plain reference
kept with the benchmark (``erdabench/families/hybrid_moe.py``), on the CPU
in float32 at ``scaled_down`` size, on the family's own seeded weights:
prefill logits; prefill and then decode through the cache against the
reference's full forward; ``train_loss`` and every gradient.  Each part of
the published equations the port could leave out — each µP scalar, the
gated RMSNorm, the conv bias, the shared expert — and a RoPE left on, fail
the comparison.  Also: the family's weight tree is the port's, the
parameter count is the tree's, the softmax ``scale`` argument of every
attention path, a default config's logits unchanged to the bit, and a
hybrid_moe cache (Mamba ``conv``/``h`` beside KV) through the Erda page
store and a preempted ``ServeEngine``.  No JAX: the JAX package has no such
family."""
import dataclasses
import hashlib
import math

import numpy as np
import pytest
import torch

from erdabench import cell as cells
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.launch.serve import page_store_for, snapshot_pages
from repro_torch.models import get_model
from repro_torch.models.layers import attention as A
from repro_torch.serving import ServeEngine
from repro_torch.serving.kv_store import MAX_SHARD_BYTES, page_shard_config
from repro_torch.tree import flatten_with_path

CPU = torch.device("cpu")
FAMILY = cells.family_module({"family": "hybrid_moe"})
#: one Mamba2 and one attention layer, float32
SMALL = dataclasses.replace(get_config("granite_h_small").scaled_down(), dtype="float32")
#: both mixers twice, so that each kind's cache entries are stacked and
#: interleaved; capacity 8, as the watch list runs it, so that a prefill
#: and the decode steps after it drop no (token, expert) pair and the
#: reference's one pass over the whole sequence routes alike
FOUR = dataclasses.replace(SMALL, n_layers=4, capacity_factor=8.0,
                           layer_types=("mamba", "attention", "mamba", "attention"))
#: the largest logit gap between the port and the reference, both in
#: float32: the port's chunked SSD, batched capacity dispatch and fused
#: loss reassociate the reference's sums (widest reading 2.8e-8 on logits
#: of up to 0.09; the float8 control reads 6.0e-3), so 1e-5 leaves room for
#: another CPU's BLAS and still fails every planted departure below
LOGIT_TOL = 1e-5
#: each gradient leaf's largest gap over the leaf's largest entry (widest
#: reading 2.0e-6: float32 sums in another order through the backward)
GRAD_TOL = 1e-4


def model_dict(cfg):
    return dataclasses.asdict(cfg)


def weights(cfg, seed=3):
    return FAMILY.make_params(model_dict(cfg), seed, CPU)


def tokens(cfg, n, batch=2, seed=1):
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(0, cfg.vocab_size, (batch, n), generator=gen, dtype=torch.int32)


def port_served_logits(cfg, params, prompts, served):
    """(R, n, V): the last prompt position's logits, then each step's with
    the served tokens fed, through ``prefill`` and ``decode_step``."""
    model = get_model(cfg, CPU)
    with torch.inference_mode():
        logits, cache = model.prefill(params, {"tokens": prompts})
        out = [logits[:, 0]]
        for i in range(served.shape[1] - 1):
            logits, cache = model.decode_step(params, cache, served[:, i:i + 1])
            out.append(logits[:, 0])
    return torch.stack(out, 1)


def ref_served_logits(cfg, params, prompts, served, precision="fp32"):
    ref = FAMILY.Reference(model_dict(cfg), precision)
    return torch.stack(FAMILY.served_logits(ref, params, prompts, served))


def without(params, *path):
    """A copy of the tree without the leaf or node at ``path`` in every
    layer that has it."""
    def drop(tree, keys):
        if not isinstance(tree, dict) or keys[0] not in tree:
            return tree
        if len(keys) == 1:
            return {k: v for k, v in tree.items() if k != keys[0]}
        return dict(tree, **{keys[0]: drop(tree[keys[0]], keys[1:])})
    return dict(params, layers=[drop(lp, path) for lp in params["layers"]])


def served_gap(port_cfg=FOUR, port_params=None, prompt=24, n=5):
    """The port's served logits (its config and weights possibly altered)
    against the reference's full forward on ``FOUR`` and its weights."""
    params = weights(FOUR)
    toks = tokens(FOUR, prompt + n)
    prompts, served = toks[:, :prompt], toks[:, prompt:]
    got = port_served_logits(port_cfg, params if port_params is None else port_params,
                             prompts, served)
    want = ref_served_logits(FOUR, params, prompts, served)
    return float((got - want).abs().max())


# ----------------------------------------------------------------- parity
@pytest.mark.parametrize("cfg", [SMALL, FOUR], ids=["small", "four"])
def test_prefill_logits_match_reference(cfg):
    """At the config's own capacity (SMALL: 1.25, 48 prompt tokens in one
    group of 48, 16 slots an expert), the port and the reference drop the
    same pairs."""
    params = weights(cfg)
    prompts = tokens(cfg, 48)
    model = get_model(cfg, CPU)
    with torch.inference_mode():
        got, _ = model.prefill(params, {"tokens": prompts})
    want = ref_served_logits(cfg, params, prompts, prompts[:, :1])
    np.testing.assert_allclose(got[:, 0].numpy(), want[:, 0].numpy(), rtol=0, atol=LOGIT_TOL)


def test_prefill_then_decode_matches_reference_forward():
    assert served_gap() <= LOGIT_TOL


def test_float8_control_fails_the_comparison():
    params = weights(FOUR)
    toks = tokens(FOUR, 29)
    low = ref_served_logits(FOUR, params, toks[:, :24], toks[:, 24:], "fp8")
    want = ref_served_logits(FOUR, params, toks[:, :24], toks[:, 24:])
    assert float((low - want).abs().max()) > 100 * LOGIT_TOL


def test_train_loss_and_gradients_match_reference():
    params = weights(FOUR)
    toks = tokens(FOUR, 32)
    leaves = lambda tree: [t for _p, t in flatten_with_path(tree)]
    grad_tree = lambda: torch.utils._pytree.tree_map(
        lambda t: t.detach().clone().requires_grad_(True), params)
    pa, pb = grad_tree(), grad_tree()
    got = get_model(FOUR, CPU).train_loss(pa, {"tokens": toks})
    want = FAMILY.Reference(model_dict(FOUR)).loss(pb, toks)
    assert abs(float(got.detach()) - float(want.detach())) <= LOGIT_TOL
    ga = torch.autograd.grad(got, leaves(pa))
    gb = torch.autograd.grad(want, leaves(pb))
    for (path, _t), a, b in zip(flatten_with_path(pa), ga, gb):
        scale = float(b.abs().max())
        assert scale > 0, path
        assert float((a - b).abs().max()) <= GRAD_TOL * scale, path


#: a part of the published equations left out of the port (config or
#: weights altered), while the reference keeps it
MUTATIONS = {
    "embedding_multiplier": lambda p: (dataclasses.replace(FOUR, embedding_multiplier=1.0), p),
    "attention_multiplier": lambda p: (dataclasses.replace(FOUR, attention_multiplier=0.0), p),
    "residual_multiplier": lambda p: (dataclasses.replace(FOUR, residual_multiplier=1.0), p),
    "logits_scaling": lambda p: (dataclasses.replace(FOUR, logits_scaling=1.0), p),
    "gated_rmsnorm": lambda p: (dataclasses.replace(FOUR, ssm_gated_norm=False), p),
    "conv_bias": lambda p: (FOUR, without(p, "ssm", "conv_b")),
    "shared_expert": lambda p: (FOUR, without(p, "moe", "shared")),
    "rope_left_on": lambda p: (dataclasses.replace(FOUR, rope_theta=10_000.0), p),
}


@pytest.mark.parametrize("name", sorted(MUTATIONS))
def test_each_departure_fails_the_comparison(name):
    cfg, params = MUTATIONS[name](weights(FOUR))
    assert served_gap(cfg, params) > 10 * LOGIT_TOL


# --------------------------------------------------------- weights, count
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_family_weights_are_the_programs_tree(dtype):
    cfg = dataclasses.replace(FOUR, dtype=dtype)
    want = sorted((p, tuple(t.shape), t.dtype)
                  for p, t in flatten_with_path(get_model(cfg, CPU).init(0)))
    got = sorted((p, tuple(t.shape), t.dtype) for p, t in flatten_with_path(weights(cfg)))
    assert got == want


@pytest.mark.parametrize("cfg", [get_config("granite_h_small"), SMALL, FOUR],
                         ids=["full", "small", "four"])
def test_param_count_is_the_initialised_tree(cfg):
    tree = get_model(cfg, CPU).init_abstract()
    assert cfg.param_count() == sum(t.numel() for _p, t in flatten_with_path(tree))


def test_benchmark_config_is_the_ports():
    """The model the benchmark serves (``erdabench/configs/granite_h_small.json``)
    is the port's ``granite_h_small`` config, field for field."""
    from repro_torch.configs.base import ModelConfig
    model = cells.load_json(cells.ROOT / "erdabench" / "configs" / "granite_h_small.json")["model"]
    assert ModelConfig(**model) == get_config("granite_h_small")


def test_full_config_is_the_published_shape():
    cfg = get_config("granite_h_small")
    assert [i for i, t in enumerate(cfg.layer_types) if t == "attention"] == [5, 15, 25, 35]
    assert (cfg.ssm_heads, cfg.ssm_head_dim, cfg.d_inner, cfg.n_experts) == (128, 64, 8192, 72)
    assert cfg.param_count() == 32_207_337_984


# ------------------------------------------------------------- the scale
def attention_inputs(s=20, h=4, kv=2, hd=32, seed=0):
    gen = torch.Generator().manual_seed(seed)
    q = torch.randn(2, s, h, hd, generator=gen)
    k = torch.randn(2, s, kv, hd, generator=gen)
    v = torch.randn(2, s, kv, hd, generator=gen)
    return q, k, v


def softmax_attention(q, k, v, scale):
    """float64 causal softmax(scale · q kᵀ) v with KV repeated for GQA."""
    G = q.shape[2] // k.shape[2]
    k, v = (t.double().repeat_interleave(G, dim=2) for t in (k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", q.double() * scale, k)
    S = q.shape[1]
    s = s.masked_fill(~torch.ones(S, S, dtype=torch.bool).tril(), float("-inf"))
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v)


@pytest.mark.parametrize("scale", [None, 0.0078125])
def test_every_attention_path_takes_the_scale(scale):
    q, k, v = attention_inputs()
    want = softmax_attention(q, k, v, 1 / math.sqrt(32) if scale is None else scale)
    G = q.shape[2] // k.shape[2]
    kr, vr = k.repeat_interleave(G, dim=2), v.repeat_interleave(G, dim=2)
    paths = {
        "flash_attention": ops.flash_attention(q, kr, vr, causal=True, scale=scale),
        "full": A.full_attention(q, k, v, causal=True, scale=scale),
        "chunked": A.chunked_attention(q, k, v, dataclasses.replace(SMALL, attn_chunk=8),
                                       causal=True, scale=scale),
        "banded": A.banded_attention(q, k, v, dataclasses.replace(SMALL, attn_chunk=8),
                                     window=20, scale=scale),
    }
    for name, got in paths.items():
        np.testing.assert_allclose(got.double().numpy(), want.numpy(), rtol=1e-5, atol=1e-5,
                                   err_msg=name)
    pos = torch.arange(20, dtype=torch.int32)
    last = A.decode_attention(q[:, -1:], k, v, pos, 19, scale=scale)
    np.testing.assert_allclose(last.double().numpy(), want[:, -1:].numpy(), rtol=1e-5, atol=1e-5)


#: sha256 (first 16 hex digits) of the float32 bytes of three scaled-down
#: models' prefill logits, three decode steps' logits and the train loss,
#: one thread, as the tree before the hybrid_moe family computed them: the
#: new fields' defaults change no bit of any other family
DEFAULT_DIGESTS = {("olmo_1b", "bfloat16"): "3bfab8d734630e8f",
                   ("olmo_1b", "float32"): "813397504d917746",
                   ("granite_moe_3b", "bfloat16"): "cf1d50ab338655f9",
                   ("granite_moe_3b", "float32"): "be29ef6eeae75221",
                   ("zamba2_1p2b", "bfloat16"): "fd9f0a25bbb6bfd1",
                   ("zamba2_1p2b", "float32"): "8a701694598d2dc6"}


@pytest.mark.parametrize("arch,dtype", sorted(DEFAULT_DIGESTS))
def test_defaults_keep_other_families_bit_for_bit(arch, dtype):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cfg = dataclasses.replace(get_config(arch).scaled_down(), dtype=dtype)
        model = get_model(cfg, CPU)
        params = model.init(0)
        toks = torch.from_numpy(np.random.default_rng(0).integers(
            0, cfg.vocab_size, (2, 24)).astype(np.int32))
        h = hashlib.sha256()
        with torch.inference_mode():
            logits, cache = model.prefill(params, {"tokens": toks[:, :20]})
            h.update(logits.float().numpy().tobytes())
            for i in range(20, 23):
                logits, cache = model.decode_step(params, cache, toks[:, i:i + 1])
                h.update(logits.float().numpy().tobytes())
        h.update(model.train_loss(params, {"tokens": toks}).detach().float().numpy().tobytes())
    finally:
        torch.set_num_threads(threads)
    assert h.hexdigest()[:16] == DEFAULT_DIGESTS[arch, dtype]


# ------------------------------------------------------ SSM state, Erda
#: narrower widths: the CPU's plain CRC loops over every byte of a page
TINY = dataclasses.replace(SMALL, d_model=64, ssm_head_dim=32, ssm_state=8, head_dim=32,
                           n_heads=2, vocab_size=64, d_ff=32, d_ff_shared=64)


def test_cache_through_the_page_store_is_bit_identical():
    model = get_model(TINY, CPU)
    params = model.init(0)
    with torch.inference_mode():
        _l, cache = model.prefill(params, {"tokens": tokens(TINY, 16)})
    names = [p for p, _t in flatten_with_path(cache)]
    assert {"['ssm']['h']", "['ssm']['conv']", "['full']['k']", "['full']['v']"} <= set(names)
    pages = page_store_for(TINY, 2, 16, 8, 2, CPU)
    pages.snapshot_cache(3, cache)
    back = pages.restore_cache(3, cache)
    for (path, a), (_p, b) in zip(flatten_with_path(cache), flatten_with_path(back)):
        assert a.dtype == b.dtype and torch.equal(a, b), path


def test_preempted_generate_equals_clean():
    model = get_model(TINY, CPU)
    params = model.init(0)
    batch = {"tokens": tokens(TINY, 16)}
    clean = ServeEngine(model, params, snapshot_every=2, device=CPU).generate(batch, 8, seq_id=1)
    engine = ServeEngine(model, params, device=CPU, snapshot_every=2,
                         page_store=page_store_for(TINY, 2, 16, 8, 2, CPU))
    crashy = engine.generate(batch, 8, seq_id=2, crash_at=5)
    np.testing.assert_array_equal(clean, crashy)
    assert engine.pages.stats["reads"] > 0


def test_cell_snapshot_fits_a_shard():
    """At granite_h_small.rag_8k's shapes, a snapshot holds 302 MB of
    float32 SSM state, 3.6 MB of conv state and 272.6 MB of KV; two
    snapshots (16 tokens at every 16, and one after a recovery) fit a shard."""
    pages = dict(snapshot_pages(get_config("granite_h_small"), 2, 8192, 16))
    assert pages["['ssm']['h']"] == 36 * 2 * 128 * 64 * 128 * 4
    assert pages["['ssm']['conv']"] == 36 * 2 * 3 * (8192 + 2 * 128) * 2
    assert pages["['full']['k']"] == pages["['full']['v']"] == 4 * 2 * (8192 + 128) * 8 * 128 * 2
    shard = page_shard_config(list(pages.items()), 2)
    assert sum(pages.values()) == 578_402_436 and shard.device_size <= MAX_SHARD_BYTES
