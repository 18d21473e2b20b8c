"""The port's model layers (``repro_torch.models.layers``) against the JAX
package's on the same float32 inputs and weights, made with numpy: norms,
RoPE, MLPs, embeddings, the QKV projection and every attention function the
serving path runs, within the reference's float32 tolerance (2e-5)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models.layers import attention as JA
from repro.models.layers import basic as JB
from repro_torch.models.layers import attention as TA
from repro_torch.models.layers import basic as TB

TOL = dict(rtol=2e-5, atol=2e-5)


def cfg(**kw):
    return dataclasses.replace(get_config("olmo_1b").scaled_down(),
                               dtype="float32", **kw)


def rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def both(a):
    return jnp.asarray(a), torch.from_numpy(np.array(a))


def close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **tol)


@pytest.mark.parametrize("kind", ["layernorm", "nonparam_ln", "rmsnorm"])
@pytest.mark.parametrize("with_scale", [False, True])
def test_norms(kind, with_scale):
    rng = np.random.default_rng(0)
    jx, tx = both(rand(rng, 2, 5, 128) * 3 + 1)
    p = {"scale": rand(rng, 128)} if with_scale else {}
    close(TB.apply_norm({k: torch.from_numpy(v) for k, v in p.items()}, tx, kind),
          JB.apply_norm({k: jnp.asarray(v) for k, v in p.items()}, jx, kind))


def test_norm_keeps_bf16_and_init_norm_shapes():
    x = torch.randn(2, 3, 128).to(torch.bfloat16)
    assert TB.apply_norm({}, x, "rmsnorm").dtype == torch.bfloat16
    g = torch.Generator().manual_seed(0)
    assert TB.init_norm(cfg(), g) == {}  # olmo: non-parametric LayerNorm
    assert TB.init_norm(cfg(norm="rmsnorm"), g)["scale"].shape == (128,)


@pytest.mark.parametrize("positions", [np.arange(7), np.array([41])])
def test_rope_split_halves(positions):
    rng = np.random.default_rng(1)
    jx, tx = both(rand(rng, 2, len(positions), 4, 32))
    close(TB.apply_rope(tx, torch.from_numpy(positions), 10_000.0),
          JB.apply_rope(jx, jnp.asarray(positions), 10_000.0))
    assert torch.equal(TB.apply_rope(tx, torch.from_numpy(positions), 0.0), tx)


def test_rope_frequencies_are_the_reference_values_and_serve_training():
    """One set of frequencies, the reference's float32 theta^(-2i/hd) to
    the last place, from the CPU, made once per (head_dim, theta, device);
    first asked for in
    inference mode (serving), it still takes part in a backward pass."""
    with torch.inference_mode():
        freqs = TB.rope_frequencies(256, 1_000_000.0, torch.device("cpu"))
    # XLA's pow and PyTorch's may differ in the last place (4 of 128 here)
    np.testing.assert_allclose(freqs.numpy(),
                               np.asarray(JB.rope_frequencies(256, 1_000_000.0)),
                               rtol=2.4e-7, atol=0)
    assert TB.rope_frequencies(256, 1_000_000.0, torch.device("cpu")) is freqs
    assert not freqs.is_inference()
    x = torch.ones(1, 3, 2, 256, requires_grad=True)
    TB.apply_rope(x, torch.arange(3), 1_000_000.0).sum().backward()
    assert x.grad.shape == x.shape


@pytest.mark.parametrize("mlp_kind,act", [("swiglu", "silu"), ("gelu_mlp", "gelu")])
def test_mlps(mlp_kind, act):
    c = cfg(mlp_kind=mlp_kind, act=act)
    rng = np.random.default_rng(2)
    names = ("wg", "wi", "wo") if mlp_kind == "swiglu" else ("wi", "wo")
    shapes = {"wg": (128, 256), "wi": (128, 256), "wo": (256, 128)}
    p = {n: rand(rng, *shapes[n]) * 0.1 for n in names}
    jx, tx = both(rand(rng, 2, 5, 128))
    close(TB.apply_mlp({k: torch.from_numpy(v) for k, v in p.items()}, tx, c),
          JB.apply_mlp({k: jnp.asarray(v) for k, v in p.items()}, jx, c))
    got = TB.init_mlp(c, torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in got.items()} == {n: shapes[n] for n in names}


@pytest.mark.parametrize("tie", [True, False])
def test_embed_unembed(tie):
    rng = np.random.default_rng(3)
    p = {"table": rand(rng, 512, 128)}
    if not tie:
        p["unembed"] = rand(rng, 128, 512)
    tokens = rng.integers(0, 512, size=(2, 9)).astype(np.int32)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    x = TB.embed(tp, torch.from_numpy(tokens))
    close(x, JB.embed(jp, jnp.asarray(tokens)))
    close(TB.unembed(tp, x), JB.unembed(jp, jnp.asarray(x.numpy())))


def test_dense_init_scale():
    g = torch.Generator().manual_seed(0)
    w = TB.dense_init(g, (512, 256), torch.float32)
    assert abs(float(w.std()) - 1 / np.sqrt(512)) < 2e-3
    assert TB.dense_init(g, (64, 8), torch.bfloat16).dtype == torch.bfloat16


def attn_params(rng, c):
    return {"wq": rand(rng, 128, c.q_dim) * 0.1, "wk": rand(rng, 128, c.kv_dim) * 0.1,
            "wv": rand(rng, 128, c.kv_dim) * 0.1, "wo": rand(rng, c.q_dim, 128) * 0.1}


@pytest.mark.parametrize("n_kv", [4, 2])
def test_qkv_with_rope(n_kv):
    c = cfg(n_kv_heads=n_kv)
    rng = np.random.default_rng(4)
    p = attn_params(rng, c)
    jx, tx = both(rand(rng, 2, 6, 128))
    pos = np.arange(6)
    got = TA.qkv({k: torch.from_numpy(v) for k, v in p.items()}, tx, c,
                 torch.from_numpy(pos))
    want = JA.qkv({k: jnp.asarray(v) for k, v in p.items()}, jx, c, jnp.asarray(pos))
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        close(g, w)


def qkv_inputs(seed, sq, skv, h=4, kv=2, hd=32):
    rng = np.random.default_rng(seed)
    return rand(rng, 2, sq, h, hd), rand(rng, 2, skv, kv, hd), rand(rng, 2, skv, kv, hd)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("kv", [4, 2, 1])
def test_full_attention(causal, kv):
    q, k, v = qkv_inputs(5, 24, 24, kv=kv)
    close(TA.full_attention(*map(torch.from_numpy, (q, k, v)), causal=causal),
          JA.full_attention(*map(jnp.asarray, (q, k, v)), causal=causal))


@pytest.mark.parametrize("s,chunk", [(96, 32), (100, 32), (64, 16)])
@pytest.mark.parametrize("causal", [True, False])
def test_chunked_attention(s, chunk, causal):
    c = cfg(attn_chunk=chunk)
    q, k, v = qkv_inputs(6, s, s)
    close(TA.chunked_attention(*map(torch.from_numpy, (q, k, v)), c, causal=causal),
          JA.chunked_attention(*map(jnp.asarray, (q, k, v)), c, causal=causal))


@pytest.mark.parametrize("pos", [0, 9, 12, 15])
def test_decode_attention(pos):
    q, k, v = qkv_inputs(7, 1, 16)
    kv_pos = np.where(np.arange(16) < 12, np.arange(16), -1).astype(np.int32)
    got = TA.decode_attention(*map(torch.from_numpy, (q, k, v, kv_pos)),
                              torch.tensor(pos, dtype=torch.int32))
    want = JA.decode_attention(*map(jnp.asarray, (q, k, v, kv_pos)), jnp.int32(pos))
    close(got, want)


@pytest.mark.parametrize("pos", [3, 15, 20, -1])
def test_cache_update(pos):
    rng = np.random.default_rng(8)
    kc, vc = rand(rng, 2, 16, 2, 32), rand(rng, 2, 16, 2, 32)
    kp = np.full(16, -1, np.int32)
    kn, vn = rand(rng, 2, 1, 2, 32), rand(rng, 2, 1, 2, 32)
    t_in = [torch.from_numpy(a.copy()) for a in (kc, vc, kp, kn, vn)]
    got = TA.cache_update(*t_in, torch.tensor(pos, dtype=torch.int32))
    want = JA.cache_update(*map(jnp.asarray, (kc, vc, kp, kn, vn)), jnp.int32(pos))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert torch.equal(t_in[0], torch.from_numpy(kc))  # out of place
